"""HTTP REST connector: each request becomes a row of a query table, and
its answer is the row of the response table with the same key.

Parity with the JAX package's ``io/http.py`` (reference
``python/pathway/io/http``): ``PathwayWebserver`` (one server hosting
several routes), ``rest_connector`` returning ``(query_table,
response_writer)``, ``RestApiError`` and the endpoint documentation
classes. The routes, status codes, JSON bodies and the port-0 ephemeral
bind (``webserver.port`` read back after binding) are JAX's.

The server is the standard library's ``http.server.ThreadingHTTPServer``
(JAX's runs on aiohttp, which the port does not need): a request is
handled on its own thread, which commits the request's row and waits for
its answer. A route handler is a function of the request's payload (a
POST's JSON body, a GET's query parameters); JAX's are coroutine
functions on aiohttp's loop.

A request's commit wakes the other sources' heartbeats, so its time is
processed at once (JAX's waits for the next heartbeat of every idle
source, up to 500 ms). The server stops when the last connector that
started it stops (a live
``pw.run()`` ends with ``c._stop.set(); c.close()`` on its connectors, as
in JAX); requests still waiting then get a 503. ``stop()`` stops it
directly (a server whose routes were registered by hand).

The streaming HTTP reader and writer (``read``, ``write``,
``RetryPolicy``, ``HttpStreamingSubject``) are not ported yet (ROADMAP
A13).
"""

from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlsplit

from pathway_tpu_torch.engine.clock import kick_heartbeats
from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.operators.output import SubscribeNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.json import unwrap_json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.io._utils import format_value_for_output, parse_record_fields


class EndpointExamples:
    """Named request examples for endpoint documentation (reference
    ``io/http/_server.py:89``)."""

    def __init__(self):
        self.examples_by_id: dict = {}

    def add_example(self, id, summary, values):  # noqa: A002
        if id in self.examples_by_id:
            raise ValueError(f"duplicate example id {id!r}")
        self.examples_by_id[id] = {"summary": summary, "value": values}
        return None


class EndpointDocumentation:
    """OpenAPI-style endpoint docs (reference ``EndpointDocumentation:126``)."""

    def __init__(self, summary: str = "", description: str = "", tags=(), method_types=("POST",)):
        self.summary = summary
        self.description = description
        self.tags = list(tags)
        self.method_types = list(method_types)


class RestApiError(Exception):
    """A structured HTTP failure a handler wants returned verbatim:
    ``status`` + JSON ``payload`` (+ optional ``Retry-After``), instead of
    the generic 500 wrapper. Raised by ``_RestConnector._handle`` when the
    resolved result carries the ``_pw_http_error`` envelope that the
    serving layers use to ship typed failures through the dataflow."""

    def __init__(self, status: int, payload: dict,
                 retry_after: float | None = None):
        super().__init__(payload.get("error", "request failed"))
        self.status = int(status)
        self.payload = payload
        self.retry_after = retry_after


class PathwayWebserver:
    """Shared HTTP server hosting one or more rest_connector routes."""

    def __init__(self, host: str, port: int, with_cors: bool = False, with_schema_endpoint: bool = True):
        self.host = host
        self.port = port
        self._routes: dict[tuple[str, str], Any] = {}
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._lock = threading.Lock()
        self._attached = 0  # connectors whose run holds the server open

    def _register(self, route: str, methods: list[str], handler) -> None:
        for m in methods:
            self._routes[(m.upper(), route)] = handler

    def _unregister(self, route: str, methods: list[str], handler) -> None:
        for m in methods:
            if self._routes.get((m.upper(), route)) is handler:
                del self._routes[(m.upper(), route)]

    def start(self) -> None:
        """Bind and serve on a daemon thread; a bind failure raises. With
        port 0 the port the OS picked is read back into ``self.port``."""
        with self._lock:
            if self._thread is not None:
                return
            httpd = _Server((self.host, self.port), self._handler_class())
            self.port = httpd.server_address[1]
            self._httpd = httpd
            self._thread = threading.Thread(
                target=httpd.serve_forever, kwargs={"poll_interval": 0.1},
                daemon=True, name=f"PathwayWebserver:{self.port}")
            self._thread.start()
            self._started.set()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop serving, close the socket and join the serving thread."""
        with self._lock:
            httpd, thread = self._httpd, self._thread
            self._httpd = self._thread = None
            self._started.clear()
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout)

    def _attach(self) -> None:
        with self._lock:
            self._attached += 1
        self.start()

    def _detach(self) -> None:
        with self._lock:
            self._attached -= 1
            last = self._attached == 0
        if last:
            self.stop()

    def _dispatch(self, method: str, path: str, query: str, body: bytes) -> tuple:
        """(status, content type, body bytes, extra headers) of one request."""
        handler = self._routes.get((method, path))
        if handler is None:
            return _json_reply(404, {"error": "no such endpoint"})
        try:
            if method in ("POST", "PUT", "PATCH"):
                try:
                    payload = json.loads(body) if body else {}
                except json.JSONDecodeError:
                    payload = {}
            else:
                payload = {k: v[0] for k, v in parse_qs(query).items()}
            result = handler(payload)
            # handlers carrying _raw_content_type return preformatted text
            # (e.g. the /metrics OpenMetrics exposition), not JSON
            raw_ct = getattr(handler, "_raw_content_type", None)
            if raw_ct is not None:
                return 200, f"{raw_ct}; charset=utf-8", str(result).encode(), {}
            return _json_reply(200, result)
        except RestApiError as exc:
            headers = {}
            if exc.retry_after is not None:
                headers["Retry-After"] = str(max(1, int(round(exc.retry_after))))
            return _json_reply(exc.status, exc.payload, headers)
        except Exception as exc:  # noqa: BLE001
            return _json_reply(500, {"error": str(exc)})

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _serve(self):
                parts = urlsplit(self.path)
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n > 0 else b""
                status, ctype, data, headers = server._dispatch(
                    self.command, parts.path, parts.query, body)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _serve

            def log_message(self, format, *args):  # noqa: A002
                pass

        return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog aiohttp uses: a burst of clients connecting at
    # once must not overflow it (the standard library's default is 5)
    request_queue_size = 128
    # stop() does not wait for request threads (daemons, each bounded by
    # its own request): a stop must not hang on a slow client
    block_on_close = False


def _json_reply(status: int, payload, headers: dict | None = None) -> tuple:
    return (status, "application/json; charset=utf-8", json.dumps(payload).encode(),
            headers or {})


class _Pending:
    __slots__ = ("done", "result", "error")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.error: RestApiError | None = None


class _RestConnector(BaseConnector):
    heartbeat_ms = 500

    def __init__(self, node, schema, webserver: PathwayWebserver, route: str, methods, delete_completed_queries: bool):
        super().__init__(node)
        self.schema = schema
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.delete_completed = delete_completed_queries
        self._pending: dict[int, _Pending] = {}
        self._pending_lock = threading.Lock()
        self._stopping = False  # set once the run's pending requests are failed

    def _handle(self, payload: dict):
        cols = list(self.node.column_names)
        dtypes = {n: c.dtype for n, c in self.schema.__columns__.items()}
        values = parse_record_fields(payload, cols, dtypes, self.schema)
        key = hash_values(str(uuid.uuid4()))
        pending = _Pending()
        with self._pending_lock:
            if self._stopping:  # the handler was looked up before the stop
                raise RestApiError(503, {"error": "server stopped"})
            self._pending[key] = pending
        row = tuple(values[c] for c in cols)
        self.commit_rows([(key, row, 1)])
        # the row's time is processed once every live source's frontier
        # passes it: wake the idle sources' heartbeats now instead of
        # leaving the request parked for up to their 500 ms cadence
        kick_heartbeats()
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        result = pending.result
        if self.delete_completed:
            self.commit_rows([(key, row, -1)])
        if isinstance(result, dict) and "_pw_http_error" in result:
            # typed failure envelope from the serving layers (see
            # xpacks/llm/servers.map_serving_errors): surface it as the
            # HTTP status it names instead of a 200 with an error body
            err = result["_pw_http_error"]
            raise RestApiError(
                int(err.get("status", 500)),
                {"error": err.get("error", "request failed"),
                 "reason": err.get("reason", "error")},
                retry_after=err.get("retry_after"),
            )
        return result

    def resolve(self, key: int, result: Any) -> None:
        with self._pending_lock:
            pending = self._pending.pop(key, None)
        if pending is None:
            return
        pending.result = result
        pending.done.set()

    def _fail_pending(self) -> None:
        with self._pending_lock:
            self._stopping = True
            pending, self._pending = list(self._pending.values()), {}
        for p in pending:
            p.error = RestApiError(503, {"error": "server stopped"})
            p.done.set()

    def run(self):
        with self._pending_lock:
            self._stopping = False
        self.webserver._register(self.route, self.methods, self._handle)
        self.webserver._attach()
        try:
            # stay alive until stopped; frontier stays open (live service)
            self._stop.wait()
        finally:
            self.webserver._unregister(self.route, self.methods, self._handle)
            self._fail_pending()
            self.webserver._detach()


class RestServerResponseWriter:
    def __init__(self, connector: _RestConnector):
        self._connector = connector

    def __call__(self, response_table: Table) -> None:
        conn = self._connector

        def on_change(key, row, time, is_addition):
            if not is_addition:
                return
            if "result" in row:
                result = format_value_for_output(row["result"])
            else:
                result = {
                    c: format_value_for_output(v) for c, v in row.items()
                }
            conn.resolve(key.value, unwrap_json(result))

        node = SubscribeNode(
            G.engine_graph,
            response_table._node,
            on_change=on_change,
            skip_errors=False,
        )
        G.register_sink(node)


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    schema: Any | None = None,
    methods: tuple = ("POST",),
    autocommit_duration_ms: int | None = 1500,
    keep_queries: bool | None = None,
    delete_completed_queries: bool = True,
    request_validator=None,
    documentation: EndpointDocumentation | None = None,
) -> tuple[Table, RestServerResponseWriter]:
    """Expose an HTTP endpoint as a (query_table, response_writer) pair."""
    if webserver is None:
        webserver = PathwayWebserver(host or "0.0.0.0", 8080 if port is None else port)  # noqa: S104
    if schema is None:
        schema = schema_mod.schema_from_types(query=str)
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"rest({route})")
    conn = _RestConnector(
        node, schema, webserver, route, list(methods), delete_completed_queries
    )
    G.register_connector(conn)
    table = Table(node, schema, Universe())
    return table, RestServerResponseWriter(conn)
