"""REST servers for document stores and QA pipelines (reference
``xpacks/llm/servers.py:16-291``).

Each endpoint is a ``rest_connector`` route: requests become rows of a query
table, the handler builds the answering sub-graph once at definition time,
and responses resolve through the dataflow. The web server is
``io/http.py``'s standard-library one; a live run ends when its
connectors are stopped (``c._stop.set(); c.close()`` on each of
``pw.G.connectors``), which also stops the server.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table

logger = logging.getLogger(__name__)


def map_serving_errors(handler: Callable[[Table], Table]) -> Callable[[Table], Table]:
    """Wrap an endpoint handler so serving failures come back as typed
    HTTP errors instead of a 200 whose body happens to contain an error.

    The continuous decode server ships per-request failures through the
    string-typed response channel as a reserved-prefix marker (see
    ``llms.encode_serve_error``). This wrapper decodes that marker out of
    the handler's ``result`` column and rewrites the row to the
    ``_pw_http_error`` envelope the webserver maps to a real status:
    admission-control sheds (``shed:*`` reasons) become 503 +
    ``Retry-After``; everything else becomes a structured 500."""
    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.xpacks.llm.llms import decode_serve_error

    def _envelope(err: dict) -> Json:
        reason = err.get("reason", "serve_failed")
        shed = reason.startswith("shed:")
        body: dict = {
            "status": 503 if shed else 500,
            "reason": reason,
            "error": (
                "request shed by admission control; retry later"
                if shed else "model serving failed for this request"
            ),
        }
        if err.get("retry_after") is not None:
            body["retry_after"] = err["retry_after"]
        elif shed:
            body["retry_after"] = 1.0
        return Json({"_pw_http_error": body})

    @pw.udf
    def _rewrite(result):
        value = result.value if isinstance(result, Json) else result
        if isinstance(value, str):
            err = decode_serve_error(value)
            if err is not None:
                return _envelope(err)
        elif isinstance(value, dict):
            resp = value.get("response")
            if isinstance(resp, str):
                err = decode_serve_error(resp)
                if err is not None:
                    return _envelope(err)
        return result

    def wrapped(queries: Table) -> Table:
        out = handler(queries)
        names = list(out.column_names())
        if "result" not in names:
            return out
        return out.select(**{
            c: (_rewrite(out[c]) if c == "result" else out[c])
            for c in names
        })

    return wrapped


class BaseRestServer:
    """Route registry over a shared webserver (reference ``BaseRestServer``,
    servers.py:16). ``profile_dir`` enables ``GET /debug/profile`` (JAX's
    ``PATHWAY_TPU_PROFILE_DIR``, off by default): traces are written under
    it (``internals/profiling.py``); build such a server on the thread that
    imported torch, where the profiler's device tracing initialises."""

    def __init__(self, host: str, port: int, profile_dir: str | None = None,
                 **rest_kwargs):
        from pathway_tpu_torch.io.http import PathwayWebserver

        self.host = host
        self.port = port
        self.profile_dir = profile_dir
        if profile_dir:
            from pathway_tpu_torch.internals import profiling

            profiling.prepare()  # the device tracing initialises on this thread
        self.webserver = PathwayWebserver(host, port)
        self.rest_kwargs = rest_kwargs
        self._thread: threading.Thread | None = None
        # readiness: set when run() hands control to the pipeline (the
        # dataflow routes register at connector start inside pw.run);
        # /readyz reports 503 until then so probes hold traffic
        self._ready = threading.Event()

    def serve(
        self,
        route: str,
        schema: type,
        handler: Callable[[Table], Table],
        documentation: Any = None,
        **additional_kwargs,
    ) -> None:
        from pathway_tpu_torch.io.http import rest_connector

        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            methods=additional_kwargs.pop("methods", ("GET", "POST")),
            delete_completed_queries=True,
        )
        writer(handler(queries))

    def start_observability_endpoints(self) -> None:
        """Register ``GET /metrics`` (OpenMetrics text over the unified
        ``MetricsRegistry``), a registry-JSON ``/v1/statistics``, the opt-in
        ``GET /debug/profile?ms=N`` trace capture, ``/healthz`` and
        ``/readyz`` on the shared webserver. Registered directly (not as
        dataflow routes), so they answer even while the pipeline is
        starting or stalled; dataflow routes register later — at connector
        start, inside ``pw.run`` — so a server that defines its own
        ``/v1/statistics`` (e.g. :class:`QARestServer`) overrides the
        registry JSON for that route while keeping ``/metrics``. A capture
        runs on its request's thread; the server's other requests go on
        meanwhile."""
        from pathway_tpu_torch.engine import probes
        from pathway_tpu_torch.internals import profiling
        from pathway_tpu_torch.internals import run as run_mod
        from pathway_tpu_torch.internals.http_server import openmetrics_text
        from pathway_tpu_torch.io.http import RestApiError

        def metrics_handler(_payload):
            return openmetrics_text()

        # the io/http.py dispatch returns this as raw text, not JSON
        metrics_handler._raw_content_type = "text/plain"

        def statistics_handler(_payload):
            return probes.unified_snapshot(
                getattr(run_mod, "LAST_RUN_STATS", None)
            )

        def profile_handler(payload):
            ms = (payload or {}).get("ms", 100)
            return profiling.capture_trace(ms, profile_dir=self.profile_dir)

        def healthz_handler(_payload):
            # liveness: answering at all IS the signal
            return "ok\n"

        healthz_handler._raw_content_type = "text/plain"

        def readyz_handler(_payload):
            if not self._ready.is_set():
                raise RestApiError(
                    503, {"error": "pipeline not started"}, retry_after=1
                )
            return "ready\n"

        readyz_handler._raw_content_type = "text/plain"

        self.webserver._register("/metrics", ["GET"], metrics_handler)
        self.webserver._register(
            "/v1/statistics", ["GET", "POST"], statistics_handler
        )
        self.webserver._register("/debug/profile", ["GET", "POST"], profile_handler)
        self.webserver._register("/healthz", ["GET"], healthz_handler)
        self.webserver._register("/readyz", ["GET"], readyz_handler)

    def run(
        self,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        terminate_on_error: bool = False,
        with_http_server: bool = False,
        config=None,
        **kwargs,
    ):
        """Start serving (reference ``run``, servers.py:68).
        ``with_http_server`` and ``config`` go to ``pw.run``."""
        self.start_observability_endpoints()

        def run_pipeline():
            self._ready.set()  # pipeline start imminent: flip /readyz
            pw.run(
                monitoring_level=pw.MonitoringLevel.NONE,
                terminate_on_error=terminate_on_error,
                with_http_server=with_http_server,
                config=config,
            )

        if threaded:
            t = threading.Thread(target=run_pipeline, daemon=True, name=f"RestServer:{self.port}")
            t.start()
            self._thread = t
            return t
        run_pipeline()


class DocumentStoreServer(BaseRestServer):
    """Serves a DocumentStore (reference ``DocumentStoreServer``,
    servers.py:92): /v1/retrieve, /v1/statistics, /v1/inputs."""

    def __init__(self, host: str, port: int, document_store, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.serve(
            "/v1/retrieve", document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
        )
        self.serve(
            "/v1/statistics", document_store.StatisticsQuerySchema,
            document_store.statistics_query,
        )
        self.serve(
            "/v1/inputs", document_store.InputsQuerySchema,
            document_store.inputs_query,
        )


class QARestServer(BaseRestServer):
    """Serves a BaseQuestionAnswerer (reference ``QARestServer``,
    servers.py:140): /v1/pw_ai_answer, /v1/retrieve, /v1/statistics,
    /v1/pw_list_documents (+ v2 aliases)."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.serve(
            "/v1/pw_ai_answer", rag_question_answerer.AnswerQuerySchema,
            map_serving_errors(rag_question_answerer.answer_query),
        )
        self.serve(
            "/v2/answer", rag_question_answerer.AnswerQuerySchema,
            map_serving_errors(rag_question_answerer.answer_query),
        )
        self.serve(
            "/v1/retrieve", rag_question_answerer.RetrieveQuerySchema,
            rag_question_answerer.retrieve,
        )
        self.serve(
            "/v2/retrieve", rag_question_answerer.RetrieveQuerySchema,
            rag_question_answerer.retrieve,
        )
        self.serve(
            "/v1/statistics", rag_question_answerer.StatisticsQuerySchema,
            rag_question_answerer.statistics,
        )
        self.serve(
            "/v1/pw_list_documents", rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
        )
        self.serve(
            "/v2/list_documents", rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
        )


class QASummaryRestServer(QARestServer):
    """QA server plus summarization endpoint (reference
    ``QASummaryRestServer``, servers.py:193)."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, rag_question_answerer, **rest_kwargs)
        self.serve(
            "/v1/pw_ai_summary", rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
        )
        self.serve(
            "/v2/summarize", rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
        )


def serve_callable(
    route: str,
    schema: type | None = None,
    host: str = "0.0.0.0",  # noqa: S104
    port: int = 8000,
    **rest_kwargs,
):
    """Expose an ad-hoc (async) function as a REST endpoint inside the
    dataflow (reference ``serve_callable``, servers.py:227)."""

    def decorator(callable_func):
        server = BaseRestServer(host, port, **rest_kwargs)
        nonlocal schema
        if schema is None:
            import inspect

            params = [
                p for p in inspect.signature(callable_func).parameters.values()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
            ]
            schema = schema_mod.schema_from_types(
                **{
                    p.name: (p.annotation if p.annotation is not inspect.Parameter.empty else str)
                    for p in params
                }
            )

        fn_udf = pw.udf(callable_func)

        def handler(queries: Table) -> Table:
            cols = [queries[c] for c in queries.column_names()]
            return queries.select(result=fn_udf(*cols))

        server.serve(route, schema, handler)
        callable_func._pw_server = server
        return callable_func

    return decorator
