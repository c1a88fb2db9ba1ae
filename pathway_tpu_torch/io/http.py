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

The streaming half is JAX's too: ``read`` turns a line-delimited
response body (jsonlines, SSE ``data:`` lines, plaintext or raw bytes) into
a live table, reconnecting and skipping the bytes it already consumed;
``write`` sends each change of a table as a JSON body from its own thread,
retrying on the ``RetryPolicy``'s schedule; ``HttpStreamingSubject`` reads
a long-lived response into ``pw.io.python.read``. All three use
``urllib``. ``read(persistent_id=...)`` makes the stream persistent: its
offset is the consumed byte count and row counter it already resumes from.
"""

from __future__ import annotations

import json
import queue
import threading
import time as time_mod
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
from pathway_tpu_torch.io._utils import (
    format_value_for_output,
    parse_record_fields,
    parse_stream_record,
)
from pathway_tpu_torch.io.python import ConnectorSubject as _PyConnectorSubject


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


class RetryPolicy:
    """Exponential-backoff retry schedule (reference ``io/http`` RetryPolicy)."""

    def __init__(self, first_delay_ms: int = 1000, backoff_factor: float = 2.0,
                 jitter_ms: int = 0):
        self.first_delay_ms = first_delay_ms
        self.backoff_factor = backoff_factor
        self.jitter_ms = jitter_ms

    @classmethod
    def default(cls) -> "RetryPolicy":
        return cls()

    def delays_s(self, n_retries: int):
        delay = self.first_delay_ms
        for _ in range(n_retries):
            yield delay / 1000.0
            delay = delay * self.backoff_factor + self.jitter_ms


def _urllib_sender(method: str, headers: dict, connect_timeout_ms: int | None,
                   request_timeout_ms: int | None):
    import urllib.request

    timeout = (request_timeout_ms or connect_timeout_ms or 30000) / 1000.0

    def send(url: str, payload: bytes) -> int:
        req = urllib.request.Request(url, data=payload, method=method, headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
            return resp.status

    return send


def _log_error(msg: str) -> None:
    from pathway_tpu_torch.internals.errors import get_global_error_log

    get_global_error_log().log(msg)


class _HttpStreamConnector(BaseConnector):
    """Streaming HTTP reader: consumes a line-delimited (jsonlines / SSE
    ``data:`` lines / plaintext / raw) response body as a live stream
    (reference ``io/http`` streaming reader). Tracks the BYTE offset of
    consumed lines: a reconnect (EOF in streaming mode) skips what was
    already ingested, so servers that re-serve the full body never
    double-count."""

    heartbeat_ms = 500

    def __init__(self, node, url: str, schema, fmt: str, headers: dict,
                 opener, mode: str, reconnect_delay_s: float = 1.0,
                 resume_with_offset: bool | None = None, sse: bool = False):
        super().__init__(node)
        self.url = url
        self.schema = schema
        self.fmt = fmt
        self.headers = headers
        self.opener = opener
        self.mode = mode
        self.reconnect_delay_s = reconnect_delay_s
        # growing-log/finite bodies re-serve consumed bytes on reconnect:
        # skip them (no double counting). Live-tail endpoints (SSE, chunked
        # push streams) send only NEW data per connection: skipping there
        # silently swallows fresh records. None = decide per connection from
        # the response: resume only for bodies with a known finite length.
        self.resume_with_offset = resume_with_offset
        # strip SSE 'data:' framing only when asked: unconditional
        # stripping would corrupt payloads that start with 'data:'
        self.sse = sse
        self._counter = 0
        self._byte_offset = 0

    def current_offset(self):
        """(consumed byte offset, row counter)."""
        return (self._byte_offset, self._counter)

    def seek_offset(self, offset) -> None:
        if isinstance(offset, (tuple, list)) and len(offset) == 2:
            self._byte_offset, self._counter = int(offset[0]), int(offset[1])

    def _row_of(self, line: bytes, cols, dtypes, pk):
        payload = line.rstrip(b"\r\n")
        if self.sse:
            if payload.startswith(b"data:"):
                payload = payload[len(b"data:"):].strip()
            elif self.fmt != "raw":
                payload = payload.strip()
        if not payload.strip():
            return None
        if self.fmt == "plaintext":
            values = {"data": payload.decode("utf-8", errors="replace").strip()}
        else:
            # raw/json share the stream-record parse with the kafka reader
            values = parse_stream_record(
                payload if self.fmt == "raw" else payload.strip(),
                self.fmt, self.schema, cols, dtypes,
            )
            if values is None:
                _log_error(f"http read: skipping undecodable line from {self.url}")
                return None
        if pk:
            key = hash_values(*[values[c] for c in pk])
        else:
            key = hash_values(self.url, self._counter)
            self._counter += 1
        return (key, tuple(values[c] for c in cols), 1)

    def _should_resume(self, resp) -> bool:
        """Skip already-consumed bytes on this connection? An explicit
        setting wins; in auto mode resume only when the body is finite or
        re-served: a Content-Length header, or a plain file-like with no
        HTTP headers at all (injected readers, file URLs). A header-bearing
        response without Content-Length is a chunked live tail: each
        connection carries only new data, so skipping would drop records."""
        if self.resume_with_offset is not None:
            return self.resume_with_offset
        if self.sse:
            return False
        headers = getattr(resp, "headers", None)
        if headers is None:
            getheader = getattr(resp, "getheader", None)
            if getheader is None:
                return True  # bare file-like: the body is the whole log
            return getheader("Content-Length") is not None
        return headers.get("Content-Length") is not None

    def _skip_consumed(self, resp) -> bool:
        """Skip bytes already ingested in a previous connection; False when
        the body is shorter than the recorded offset (nothing new)."""
        remaining = self._byte_offset
        while remaining > 0:
            chunk = resp.read(min(remaining, 65536))
            if not chunk:
                return False
            remaining -= len(chunk)
        return True

    def _wait_reconnect(self) -> None:
        # a stop request ends the wait at once
        self._stop.wait(self.reconnect_delay_s)

    def run(self):
        cols = list(self.node.column_names)
        dtypes = {n: c.dtype for n, c in self.schema.__columns__.items()}
        pk = self.schema.primary_key_columns()
        while not self.should_stop():
            try:
                resp = self.opener(self.url, self.headers)
            except Exception as exc:  # noqa: BLE001
                _log_error(f"http read connect failed: {exc!r}")
                if self.mode == "static":
                    return
                self._wait_reconnect()
                continue
            try:
                try:
                    skipped_ok = not self._should_resume(resp) or self._skip_consumed(resp)
                except Exception as exc:  # noqa: BLE001 - blip mid-skip
                    _log_error(f"http read disconnected while resuming: {exc!r}")
                    skipped_ok = False
                if not skipped_ok:
                    # log rotated/truncated below the stored offset: nothing
                    # new; back off instead of hammering the server
                    if self.mode == "static":
                        return
                    self._wait_reconnect()
                    continue
                pending: list = []
                while not self.should_stop():
                    try:
                        line = resp.readline()
                    except Exception as exc:  # noqa: BLE001 - network blip
                        _log_error(f"http read disconnected: {exc!r}")
                        break  # reconnect (streaming) / finish (static)
                    if not line:
                        break  # EOF
                    if self.mode != "static" and not line.endswith(b"\n"):
                        # partial final line (connection cut mid-record): do
                        # not consume it; the reconnect re-reads the record
                        break
                    self._byte_offset += len(line)
                    row = self._row_of(line, cols, dtypes, pk)
                    if row is not None:
                        pending.append(row)
                    if self.mode != "static" and pending:
                        # live stream: each arrived line commits promptly
                        self.commit_rows(pending)
                        pending = []
                if pending:  # static bulk body: one commit for all lines
                    self.commit_rows(pending)
            finally:
                close = getattr(resp, "close", None)
                if close is not None:
                    close()
            if self.mode == "static":
                return
            self._wait_reconnect()


def _default_opener(url: str, headers: dict, timeout_s: float | None = None):
    import urllib.request

    req = urllib.request.Request(url, headers=headers or {})
    return urllib.request.urlopen(req, timeout=timeout_s)  # noqa: S310


def read(
    url: str,
    *,
    schema=None,
    format: str = "raw",  # noqa: A002 - reference keyword
    mode: str = "streaming",
    headers: dict | None = None,
    persistent_id: str | None = None,
    connect_timeout_ms: int | None = None,
    resume_with_offset: bool | None = None,
    sse: bool = False,
    _opener=None,
    **kwargs,
) -> Table:
    """Stream a line-delimited HTTP response (jsonlines, SSE ``data:``
    lines, plaintext, or raw bytes) into a table; reconnects on EOF in
    streaming mode. ``resume_with_offset`` controls whether a reconnect
    skips already-consumed bytes: ``None`` (default) decides per
    connection (finite, re-served bodies with a Content-Length resume;
    live tails, SSE and chunked push streams, do not); a bool overrides
    both ways. ``connect_timeout_ms`` is a blanket socket timeout, which
    also bounds idle gaps between streamed lines. ``_opener(url, headers)
    -> file-like`` is injectable for offline tests."""
    if format not in ("raw", "plaintext", "json"):
        raise ValueError(f"unsupported HTTP read format {format!r}: raw/plaintext/json")
    if format in ("raw", "plaintext") and schema is not None:
        raise ValueError(
            f"schema is ignored by format={format!r}; pass format='json' "
            "to parse records into schema columns"
        )
    if format == "raw":
        schema = schema_mod.schema_from_types(data=bytes)
    elif format == "plaintext":
        schema = schema_mod.schema_from_types(data=str)
    elif schema is None:
        raise ValueError("schema is required for json-format HTTP reads")
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"http({url})")
    if _opener is None:
        timeout_s = connect_timeout_ms / 1000.0 if connect_timeout_ms else None

        def opener(u, h):
            return _default_opener(u, h, timeout_s)

    else:
        opener = _opener
    conn = _HttpStreamConnector(
        node, url, schema, format, headers or {}, opener, mode,
        resume_with_offset=resume_with_offset, sse=sse,
    )
    G.register_connector(conn)
    table = Table(node, schema, Universe())
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return table


class _QueuedHttpWriter:
    """Sends on a thread of its own, so retry backoff never stalls the
    scheduler (the reference runs writers on output joiner threads,
    dataflow.rs:3579-3617). The first send failure (after retries) is
    re-raised into the dataflow on the next batch or at the end-of-run
    flush. The thread starts with each run and ends at its flush."""

    def __init__(self, url: str, cols, sender, policy: RetryPolicy, n_retries: int):
        self.url = url
        self.cols = cols
        self.sender = sender
        self.policy = policy
        self.n_retries = n_retries
        self._queue: queue.Queue = queue.Queue(maxsize=1024)
        self._error: Exception | None = None
        self._thread: threading.Thread | None = None

    def start(self, config=None) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, name="pathway-tpu:http-sink",
                                            daemon=True)
            self._thread.start()

    def _loop(self):
        while True:
            body = self._queue.get()
            if body is None:
                return
            delays = self.policy.delays_s(self.n_retries)
            while True:
                try:
                    self.sender(self.url, body)
                    break
                except Exception as exc:
                    delay = next(delays, None)
                    if delay is None:
                        if self._error is None:
                            self._error = exc
                        break
                    time_mod.sleep(delay)

    def _check(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def __call__(self, time, batch):
        self._check()
        for _key, row, diff in batch.rows():
            payload = {c: format_value_for_output(v) for c, v in zip(self.cols, row)}
            payload["time"] = time
            payload["diff"] = diff
            self._queue.put(json.dumps(payload).encode())

    def finish(self):
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=60)
            self._thread = None
        self._check()


def write(
    table: Table,
    url: str,
    *,
    method: str = "POST",
    format: str = "json",  # noqa: A002 - reference keyword
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
    headers: dict | None = None,
    _sender=None,
) -> None:
    """POST each change of ``table`` to ``url`` as JSON (row fields plus
    ``time``/``diff``), with retry/backoff (reference ``pw.io.http.write``).
    ``_sender(url, payload) -> status`` is injectable for offline tests."""
    from pathway_tpu_torch.engine.operators.output import SinkNode

    if format != "json":
        raise ValueError("pw.io.http.write supports format='json'")
    policy = retry_policy or RetryPolicy.default()
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    sender = _sender or _urllib_sender(method, hdrs, connect_timeout_ms, request_timeout_ms)
    writer = _QueuedHttpWriter(url, table.column_names(), sender, policy, n_retries)
    node = SinkNode(G.engine_graph, table._node, writer, name=f"http({url})")
    G.register_sink(node)


class HttpStreamingSubject(_PyConnectorSubject):
    """Streams a long-lived HTTP response line by line into a table
    (reference ``io/http/_streaming.py:13``). Instantiate and pass to
    ``pw.io.python.read``; subclass and override ``run`` for custom
    protocols."""

    def __init__(self, url, *, sender=None, payload=None, headers=None,
                 delimiter=None, response_mapper=None):
        super().__init__()
        self._url = url
        self._sender = sender
        self._payload = payload
        self._headers = headers
        self._delimiter = delimiter
        self._response_mapper = response_mapper

    def run(self) -> None:
        send = self._sender or _urllib_stream_sender
        for line in send(self._url, headers=self._headers, data=self._payload,
                         delimiter=self._delimiter):
            if self._response_mapper:
                line = self._response_mapper(line)
            self.next_bytes(line if isinstance(line, bytes) else line.encode())
            self.commit()


def _urllib_stream_sender(url, *, headers=None, data=None, delimiter=None):
    import urllib.request

    if isinstance(data, str):
        data = data.encode()
    req = urllib.request.Request(url, headers=headers or {}, data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req) as resp:  # noqa: S310
        sep = delimiter if delimiter is not None else b"\n"
        if isinstance(sep, str):
            sep = sep.encode()
        buf = b""
        while True:
            chunk = resp.read(8192)
            if not chunk:
                break
            buf += chunk
            while sep in buf:
                line, buf = buf.split(sep, 1)
                yield line
        if buf:
            yield buf
