"""The port's REST connector and REST server base held against the JAX
package's: the ``rest_connector`` round trip
(``tests/test_http_misc_matrix.py:19``), ``BaseRestServer``'s
``/healthz`` and ``/readyz`` before and after the pipeline starts
(``tests/test_http_health.py:89,96``), ``/metrics`` (OpenMetrics, ends
``# EOF``) and the registry-JSON ``/v1/statistics``, the typed error
envelopes (a shed as 503 + ``Retry-After``, a failure as 500) and the
same requests to a JAX server and a port server giving equal JSON. The
port's server is the standard library's; JAX's runs on aiohttp. Servers
bind 127.0.0.1 on port 0; every wait is bounded."""

import json
import threading

import pytest

from tests.torch_engine import PACKAGES, PW
from tests.torch_rest import LiveRun, post_json, request


def _round_trip_program(pw, delete_completed):
    class QuerySchema(pw.Schema):
        q: str
        n: int = 1

    queries, writer = pw.io.http.rest_connector(
        host="127.0.0.1", port=0, schema=QuerySchema, route="/echo", methods=("GET", "POST"),
        delete_completed_queries=delete_completed)
    writer(queries.select(ans=queries.q + "!", twice=queries.n * 2))


@pytest.mark.parametrize("delete_completed", [False, True])
def test_rest_connector_round_trip_equals_jax(delete_completed):
    replies = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        _round_trip_program(pw, delete_completed)
        live = LiveRun(pkg)
        try:
            replies[pkg] = [
                post_json(f"{live.base}/echo", {"q": "hi", "n": 3}),
                post_json(f"{live.base}/echo", {"q": "default n"}),
                json.loads(request(f"{live.base}/echo?q=get")[1]),
            ]
            for payload in ({"q": f"c{i}"} for i in range(4)):
                replies[pkg].append(post_json(f"{live.base}/echo", payload))
            replies[pkg].append(request(f"{live.base}/nowhere", {"q": "x"})[:2])
        finally:
            live.stop()
            pw.clear_graph()
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0] == {"ans": "hi!", "twice": 6}
    assert replies["torch"][-1] == (404, b'{"error": "no such endpoint"}')


def test_rest_connector_concurrent_requests_and_clean_stop():
    """16 requests at once each get their own answer; after the stop the
    port's server is down and its threads are gone."""
    pw = PW["torch"]
    pw.clear_graph()
    _round_trip_program(pw, True)
    live = LiveRun("torch")
    out = [None] * 16

    def client(i):
        out[i] = post_json(f"{live.base}/echo", {"q": f"q{i}", "n": i})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        live.stop()
        pw.clear_graph()
    assert out == [{"ans": f"q{i}!", "twice": 2 * i} for i in range(16)]
    assert not live.webserver._started.is_set() and live.webserver._thread is None
    assert not [t for t in threading.enumerate() if t.name.startswith("PathwayWebserver")]


def test_pending_requests_get_503_when_the_server_stops():
    """A request whose answer never comes is released with a 503 when the
    run stops (JAX's stays pending)."""
    pw = PW["torch"]
    pw.clear_graph()

    class S(pw.Schema):
        q: str

    queries, writer = pw.io.http.rest_connector(host="127.0.0.1", port=0, schema=S,
                                                route="/never")
    writer(queries.filter(queries.q == "never matches this").select(ans=queries.q))
    live = LiveRun("torch")
    got = []
    t = threading.Thread(target=lambda: got.append(request(f"{live.base}/never", {"q": "x"})))
    t.start()
    import time

    deadline = time.monotonic() + 30
    rest = live.connectors[0]
    while not rest._pending and time.monotonic() < deadline:
        time.sleep(0.01)
    live.stop()
    t.join(30)
    pw.clear_graph()
    assert got and got[0][0] == 503 and json.loads(got[0][1]) == {"error": "server stopped"}


# ------------------------------------------------------------ BaseRestServer

@pytest.fixture(params=PACKAGES)
def rest_server(request):
    pkg = request.param
    if pkg == "torch":
        from pathway_tpu_torch.xpacks.llm.servers import BaseRestServer
    else:
        from pathway_tpu.xpacks.llm.servers import BaseRestServer
    srv = BaseRestServer("127.0.0.1", 0)
    srv.start_observability_endpoints()
    srv.webserver.start()
    yield pkg, srv, f"http://127.0.0.1:{srv.webserver.port}"
    if pkg == "torch":
        srv.webserver.stop()


def test_rest_server_healthz_before_pipeline(rest_server):
    _, _, base = rest_server
    status, body, headers = request(base + "/healthz")
    assert (status, body) == (200, b"ok\n")
    assert headers["Content-Type"].startswith("text/plain")


def test_rest_server_readyz_flips_with_pipeline_start(rest_server):
    _, srv, base = rest_server
    status, body, headers = request(base + "/readyz")
    assert status == 503 and headers.get("Retry-After") == "1"
    assert json.loads(body) == {"error": "pipeline not started"}
    srv._ready.set()  # what run()'s run_pipeline() does first
    assert request(base + "/readyz")[:2] == (200, b"ready\n")


def test_rest_server_metrics_and_statistics(rest_server):
    pkg, _, base = rest_server
    status, body, headers = request(base + "/metrics")
    assert status == 200 and body.endswith(b"# EOF\n")
    assert b"# TYPE pathway_tpu_" in body
    status, body, _ = request(base + "/v1/statistics", {})
    stats = json.loads(body)
    assert status == 200
    assert {"scheduler", "serving", "engine", "hbm", "registry"} <= set(stats)


def test_rest_server_routes_equal_jax():
    """The observability routes of both packages answer the same statuses,
    bodies and content types (``/metrics`` and ``/v1/statistics`` hold
    each package's own registry, so their shapes are compared)."""
    from pathway_tpu.xpacks.llm.servers import BaseRestServer as J
    from pathway_tpu_torch.xpacks.llm.servers import BaseRestServer as T

    seen = {}
    for pkg, cls in (("jax", J), ("torch", T)):
        srv = cls("127.0.0.1", 0)
        srv.start_observability_endpoints()
        srv.webserver.start()
        base = f"http://127.0.0.1:{srv.webserver.port}"
        try:
            rows = [request(base + p)[:2] for p in ("/healthz", "/readyz", "/nope")]
            rows.append(request(base + "/healthz", {})[:2])  # a POST to a GET route
            srv._ready.set()
            rows.append(request(base + "/readyz")[:2])
            status, body, _ = request(base + "/metrics")
            rows.append((status, body.splitlines()[-1]))
            seen[pkg] = rows
        finally:
            if pkg == "torch":
                srv.webserver.stop()
    assert seen["torch"] == seen["jax"]


# ------------------------------------------------------- error envelopes

def _error_program(pkg, reply_of):
    """A QA-shaped route whose answer UDF replies ``reply_of(prompt)``,
    behind ``map_serving_errors``."""
    pw = PW[pkg]
    if pkg == "torch":
        from pathway_tpu_torch.xpacks.llm import llms, servers
    else:
        from pathway_tpu.xpacks.llm import llms, servers

    @pw.udf
    def answer(prompt: str) -> str:
        return reply_of(llms, prompt)

    class S(pw.Schema):
        prompt: str

    def handler(queries):
        return queries.select(result=answer(queries.prompt))

    webserver = pw.io.http.PathwayWebserver("127.0.0.1", 0)
    queries, writer = pw.io.http.rest_connector(webserver=webserver, route="/v1/pw_ai_answer",
                                                schema=S, methods=("POST",))
    writer(servers.map_serving_errors(handler)(queries))

    @pw.udf
    def boom(prompt: str) -> str:
        raise ValueError("boom")

    q2, w2 = pw.io.http.rest_connector(webserver=webserver, route="/v1/fails", schema=S)
    w2(q2.select(result=boom(q2.prompt)))


def _reply(llms, prompt):
    if prompt == "shed":
        return llms.encode_serve_error("shed:queue_full", retry_after=2.6)
    if prompt == "shed-no-hint":
        return llms.encode_serve_error("shed:deadline")
    if prompt == "fail":
        return llms.encode_serve_error("serve_failed")
    return f"fine: {prompt}"


def test_error_envelopes_equal_jax():
    got = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        _error_program(pkg, _reply)
        live = LiveRun(pkg)
        try:
            rows = []
            for prompt in ("ok", "shed", "shed-no-hint", "fail"):
                status, body, headers = request(f"{live.base}/v1/pw_ai_answer",
                                                {"prompt": prompt})
                rows.append((status, json.loads(body), headers.get("Retry-After")))
            status, body, _ = request(f"{live.base}/v1/fails", {"prompt": "x"})
            rows.append((status, body))
            got[pkg] = rows
        finally:
            live.stop()
            pw.clear_graph()
    assert got["torch"] == got["jax"]
    rows = got["torch"]
    assert rows[0] == (200, "fine: ok", None)
    assert rows[1] == (503, {"error": "request shed by admission control; retry later",
                             "reason": "shed:queue_full"}, "3")
    assert rows[2][0] == 503 and rows[2][2] == "1"
    assert rows[3] == (500, {"error": "model serving failed for this request",
                             "reason": "serve_failed"}, None)


def test_rest_api_error_and_payloads_on_the_port_server():
    """A GET's query parameters and a POST's JSON body reach the handler;
    a RestApiError becomes its status and JSON; any other exception a
    500."""
    from pathway_tpu_torch.io.http import PathwayWebserver, RestApiError

    ws = PathwayWebserver("127.0.0.1", 0)

    def echo(payload):
        return {"got": payload}

    def teapot(_payload):
        raise RestApiError(418, {"error": "teapot"}, retry_after=0.2)

    def crash(_payload):
        raise KeyError("k")

    ws._register("/ok", ["GET", "POST"], echo)
    ws._register("/teapot", ["GET"], teapot)
    ws._register("/crash", ["GET"], crash)
    ws.start()
    base = f"http://127.0.0.1:{ws.port}"
    try:
        assert json.loads(request(base + "/ok?a=1&b=x")[1]) == {"got": {"a": "1", "b": "x"}}
        assert json.loads(request(base + "/ok", {"a": [1, 2]})[1]) == {"got": {"a": [1, 2]}}
        status, body, headers = request(base + "/teapot")
        assert (status, json.loads(body), headers["Retry-After"]) == (418, {"error": "teapot"}, "1")
        status, body, _ = request(base + "/crash")
        assert (status, json.loads(body)) == (500, {"error": "'k'"})
    finally:
        ws.stop()
    assert ws._thread is None
    with pytest.raises(OSError):
        # a bind failure raises: the port is taken by a live server
        other = PathwayWebserver("127.0.0.1", 0)
        other.start()
        try:
            PathwayWebserver("127.0.0.1", other.port).start()
        finally:
            other.stop()


def test_endpoint_documentation_classes_equal_jax():
    from pathway_tpu.io import http as jh
    from pathway_tpu_torch.io import http as th

    for mod in (jh, th):
        ex = mod.EndpointExamples()
        ex.add_example("a", "summary", {"q": 1})
        with pytest.raises(ValueError):
            ex.add_example("a", "again", {})
        doc = mod.EndpointDocumentation(summary="s", tags=("t",))
        assert (doc.summary, doc.tags, doc.method_types) == ("s", ["t"], ["POST"])
    assert th.EndpointExamples().__dict__ == jh.EndpointExamples().__dict__
    err = th.RestApiError(503, {"error": "x"}, retry_after=2)
    assert (err.status, err.payload, err.retry_after, str(err)) == (503, {"error": "x"}, 2, "x")


# ------------------------------------------- the other servers and pw.run

def _docs(pw):
    schema = pw.schema_from_types(data=str, _metadata=pw.Json)
    return pw.debug.table_from_rows(schema, [
        ("foo bar baz", pw.Json({"path": "a.txt", "modified_at": 1})),
        ("animal text", pw.Json({"path": "b.txt", "modified_at": 2}))])


def _fake_embedder(pw):
    import numpy as np

    @pw.udf
    def embed(x: str) -> np.ndarray:
        return np.array([1.0, 1.0, 0.0]) if "foo" in (x or "") else np.array([0.0, 1.0, 1.0])

    return embed


def _stats(stats):
    """A statistics reply without ``late_bank_bytes``: each package's
    process-wide HBM gauge, which holds what earlier tests left in it."""
    assert stats.pop("late_bank_bytes") >= 0
    return stats


def test_document_store_server_equals_jax():
    replies = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        if pkg == "torch":
            from pathway_tpu_torch.xpacks import llm
            kw = {"device": "cpu"}
        else:
            from pathway_tpu.xpacks import llm
            kw = {}
        store = llm.DocumentStore(_docs(pw), retriever_factory=pw.indexing.BruteForceKnnFactory(
            dimensions=3, embedder=_fake_embedder(pw), **kw))
        srv = llm.DocumentStoreServer("127.0.0.1", 0, store)
        live = LiveRun(pkg, webserver=srv.webserver, run=srv.run)
        try:
            replies[pkg] = [
                post_json(f"{live.base}/v1/retrieve", {"query": "foo", "k": 1}),
                _stats(post_json(f"{live.base}/v1/statistics", {})),
                post_json(f"{live.base}/v1/inputs", {}),
                json.loads(request(f"{live.base}/v1/retrieve?query=animal&k=2")[1]),
                request(f"{live.base}/healthz")[:2],
                request(f"{live.base}/readyz")[:2],
            ]
        finally:
            live.stop()
            pw.clear_graph()
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0][0]["metadata"]["path"] == "a.txt"
    assert replies["torch"][1]["file_count"] == 2
    assert replies["torch"][-1] == (200, b"ready\n")


def test_serve_callable_equals_jax():
    replies = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        if pkg == "torch":
            from pathway_tpu_torch.xpacks.llm.servers import serve_callable
        else:
            from pathway_tpu.xpacks.llm.servers import serve_callable

        @serve_callable(route="/double", host="127.0.0.1", port=0)
        def double(x: int, tag: str) -> str:
            return f"{tag}:{2 * x}"

        srv = double._pw_server
        live = LiveRun(pkg, webserver=srv.webserver, run=srv.run)
        try:
            replies[pkg] = [post_json(f"{live.base}/double", {"x": i, "tag": "t"})
                            for i in range(3)]
        finally:
            live.stop()
            pw.clear_graph()
    assert replies["torch"] == replies["jax"] == ["t:0", "t:2", "t:4"]


@pytest.mark.parametrize("level", ["NONE", None, "AUTO", "AUTO_ALL", "IN_OUT", "ALL"])
def test_run_monitoring_levels(level, monkeypatch):
    """Every server passes ``MonitoringLevel.NONE``; ``None`` and the AUTO
    levels resolve to it off a terminal, as JAX resolves them; a level
    that asks for the live monitor starts it for the run and stops it
    after, as JAX does."""
    import sys

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import monitoring

    monkeypatch.setattr(sys.stderr, "isatty", lambda: False)
    started = []
    monkeypatch.setattr(monitoring.StatsMonitor, "start",
                        lambda self: started.append(self.level))
    assert [m.name for m in pw.MonitoringLevel] == ["AUTO", "AUTO_ALL", "NONE", "IN_OUT", "ALL"]
    pw.clear_graph()
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,), (2,)])
    seen = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row["a"]))
    arg = None if level is None else pw.MonitoringLevel[level]
    pw.run(monitoring_level=arg)
    assert sorted(seen) == [1, 2]
    assert started == ([pw.MonitoringLevel[level]] if level in ("IN_OUT", "ALL") else [])
    pw.clear_graph()
