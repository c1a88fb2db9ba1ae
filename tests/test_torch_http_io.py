"""The port's ``pw.io.http`` reading and writing half held against the JAX
package's: every HTTP case of ``tests/test_http_misc_matrix.py`` and the
``http.write`` cases of ``tests/test_io_backends.py`` run on both packages
with the same injected openers and senders, the same local servers and
the same bars; the rows and the sent bodies must be equal. On top:
``RetryPolicy``'s delays, ``write`` against a real local server (bodies
and retries), ``HttpStreamingSubject`` through ``pw.io.python.read``
against a local chunked server, and ``persistent_id`` naming the reader's
snapshot log. Every wait is bounded and every test has a timeout."""

import http.server
import io as io_mod
import json
import socketserver
import threading
import time

import pytest

from tests.torch_engine import PACKAGES, PW


def _http(pkg):
    from importlib import import_module

    return import_module("pathway_tpu.io.http" if pkg == "jax" else "pathway_tpu_torch.io.http")


def _rows(pkg, table):
    if pkg == "torch":
        from pathway_tpu_torch.internals.run import capture_table
    else:
        from pathway_tpu.internals.run import capture_table
    cap = capture_table(table)
    return dict(cap.state.rows), list(cap.column_names)


def _word_schema(pw):
    class WordHttpSchema(pw.Schema):
        word: str

    return WordHttpSchema


def _stoppable(conns, pred, timeout_s=20):
    def stop():
        deadline = time.time() + timeout_s
        while time.time() < deadline and not pred():
            time.sleep(0.02)
        for c in conns:
            c._stop.set()
            c.close()

    threading.Thread(target=stop, daemon=True).start()


def _run(pkg, pw):
    if pkg == "torch":
        pw.run()
    else:
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)


def _each(fn):
    """``fn(pkg, pw)`` on both packages, each on a fresh graph; returns
    (JAX's, the port's) results."""
    out = []
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        try:
            out.append(fn(pkg, pw))
        finally:
            pw.clear_graph()
    return tuple(out)


def _streamed_words(pkg, pw, opener, **kw):
    t = pw.io.http.read("http://stub/stream", schema=_word_schema(pw), format="json",
                        mode="streaming", _opener=opener, **kw)
    seen = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row["word"]))
    conns = list(pw.G.connectors)
    hc = next(c for c in conns if isinstance(c, _http(pkg)._HttpStreamConnector))
    hc.reconnect_delay_s = 0.01
    return seen, conns


@pytest.mark.timeout(60)
def test_http_retry_policy_defaults():
    def case(pkg, pw):
        p = pw.io.http.RetryPolicy.default()
        assert p.first_delay_ms > 0
        assert p.backoff_factor >= 1
        return (p.first_delay_ms, p.backoff_factor, p.jitter_ms,
                list(p.delays_s(4)),
                list(pw.io.http.RetryPolicy(5, 3.0, 2).delays_s(5)))

    j, t = _each(case)
    assert t == j
    assert t[3] == [1.0, 2.0, 4.0, 8.0]


@pytest.mark.timeout(60)
def test_http_read_jsonlines_stream_with_injected_opener():
    def case(pkg, pw):
        bodies = [b'{"word": "a"}\n{"word": "b"}\n', b'data: {"word": "c"}\n']
        seen, conns = _streamed_words(
            pkg, pw, lambda url, headers: io_mod.BytesIO(bodies.pop(0) if bodies else b""),
            resume_with_offset=False, sse=True)
        _stoppable(conns, lambda: len(seen) >= 3)
        _run(pkg, pw)
        return seen

    j, t = _each(case)
    assert t == ["a", "b", "c"] == j


@pytest.mark.timeout(60)
def test_http_read_static_plaintext():
    def case(pkg, pw):
        t = pw.io.http.read("http://stub/page", format="plaintext", mode="static",
                            _opener=lambda url, headers: io_mod.BytesIO(b"one\ntwo\n"))
        return _rows(pkg, t)

    j, t = _each(case)
    assert sorted(r[0] for r in t[0].values()) == ["one", "two"]
    assert t == j


class _WordHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = b'{"word": "live"}\n'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _serve(handler):
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.timeout(60)
def test_http_read_real_local_server():
    srv = _serve(_WordHandler)
    port = srv.server_address[1]
    try:
        def case(pkg, pw):
            t = pw.io.http.read(f"http://127.0.0.1:{port}/", schema=_word_schema(pw),
                                format="json", mode="static", connect_timeout_ms=10_000)
            return _rows(pkg, t)

        j, (rows, cols) = _each(case)
        assert [r[cols.index("word")] for r in rows.values()] == ["live"]
        assert (rows, cols) == j
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.timeout(60)
def test_http_read_reconnect_skips_consumed_bytes():
    def case(pkg, pw):
        body = [b'{"word": "a"}\n']
        seen, conns = _streamed_words(pkg, pw,
                                      lambda url, headers: io_mod.BytesIO(b"".join(body)))

        def feed():
            deadline = time.time() + 20
            while time.time() < deadline and len(seen) < 1:
                time.sleep(0.02)
            body.append(b'{"word": "b"}\n')  # the log grows
            while time.time() < deadline and len(seen) < 2:
                time.sleep(0.02)
            time.sleep(0.2)  # several more reconnects: no duplicates
            for c in conns:
                c._stop.set()
                c.close()

        threading.Thread(target=feed, daemon=True).start()
        _run(pkg, pw)
        return seen

    j, t = _each(case)
    assert t == ["a", "b"] == j


@pytest.mark.timeout(60)
def test_http_read_raw_preserves_bytes():
    payload = b"data: \xff\x01binary\n"

    def case(pkg, pw):
        t = pw.io.http.read("http://stub/raw", format="raw", mode="static",
                            _opener=lambda url, headers: io_mod.BytesIO(payload))
        return _rows(pkg, t)

    j, (rows, cols) = _each(case)
    (row,) = rows.values()
    assert row[0] == payload.rstrip(b"\n")
    assert (rows, cols) == j


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_http_read_format_validation(pkg):
    pw = PW[pkg]
    with pytest.raises(ValueError):
        pw.io.http.read("http://x", format="csv", schema=_word_schema(pw))
    with pytest.raises(ValueError):
        pw.io.http.read("http://x", schema=_word_schema(pw))
    with pytest.raises(ValueError):
        pw.io.http.read("http://x", format="json")


@pytest.mark.timeout(60)
def test_http_read_plaintext_keeps_data_prefix():
    def case(pkg, pw):
        t = pw.io.http.read("http://stub/log", format="plaintext", mode="static",
                            _opener=lambda url, headers: io_mod.BytesIO(b"data: 42 rows\n"))
        return _rows(pkg, t)

    j, (rows, cols) = _each(case)
    (row,) = rows.values()
    assert row[0] == "data: 42 rows"
    assert (rows, cols) == j


@pytest.mark.timeout(60)
def test_http_read_partial_line_not_consumed_on_reconnect():
    def case(pkg, pw):
        bodies = [b'{"word": "a"}\n{"word": "b', b'{"word": "a"}\n{"word": "b"}\n']
        seen, conns = _streamed_words(
            pkg, pw, lambda url, headers: io_mod.BytesIO(bodies.pop(0) if bodies else b""))
        _stoppable(conns, lambda: len(seen) >= 2)
        _run(pkg, pw)
        return seen

    j, t = _each(case)
    assert t == ["a", "b"] == j


@pytest.mark.timeout(60)
def test_http_read_non_object_json_lines_skipped():
    body = b'null\n42\n[1,2]\n{"word": "ok"}\n'

    def case(pkg, pw):
        t = pw.io.http.read("http://stub/mixed", schema=_word_schema(pw), format="json",
                            mode="static", _opener=lambda url, headers: io_mod.BytesIO(body))
        return _rows(pkg, t)

    j, (rows, cols) = _each(case)
    assert [r[cols.index("word")] for r in rows.values()] == ["ok"]
    assert (rows, cols) == j


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_http_read_sse_defaults_to_no_offset_resume(pkg):
    pw = PW[pkg]
    pw.io.http.read("http://stub/sse", schema=_word_schema(pw), format="json", sse=True,
                    _opener=lambda url, headers: io_mod.BytesIO(b""))
    hc = next(c for c in pw.G.connectors if isinstance(c, _http(pkg)._HttpStreamConnector))

    class _Resp(io_mod.BytesIO):
        headers = {"Content-Length": "0"}

    class _Chunked(io_mod.BytesIO):
        headers = {}

    assert hc._should_resume(_Resp(b"")) is False
    hc.sse = False
    assert hc._should_resume(_Resp(b"")) is True
    assert hc._should_resume(_Chunked(b"")) is False
    assert hc._should_resume(io_mod.BytesIO(b"")) is True


@pytest.mark.timeout(60)
def test_http_write_posts_json():
    def case(pkg, pw):
        sent = []
        t = pw.debug.table_from_markdown(
            """
            a | b
            1 | x
            2 | y
            """
        )
        pw.io.http.write(t, "http://example.invalid/sink",
                         _sender=lambda url, body: sent.append((url, body)))
        _run(pkg, pw)
        return sorted(((u, json.loads(b)) for u, b in sent), key=lambda x: x[1]["a"])

    j, t = _each(case)
    assert len(t) == 2
    payloads = sorted((p for _u, p in t), key=lambda p: p["a"])
    assert payloads[0]["a"] == 1 and payloads[0]["b"] == "x"
    assert payloads[0]["diff"] == 1 and "time" in payloads[0]
    strip = lambda xs: [(u, {k: v for k, v in p.items() if k != "time"}) for u, p in xs]  # noqa: E731
    assert strip(t) == strip(j)


@pytest.mark.timeout(60)
def test_http_write_retries_then_raises():
    def case(pkg, pw):
        calls = []

        def flaky(url, body):
            calls.append(1)
            raise ConnectionError("down")

        t = pw.debug.table_from_markdown(
            """
            a
            1
            """
        )
        pw.io.http.write(t, "http://example.invalid/sink", n_retries=2,
                         retry_policy=pw.io.http.RetryPolicy(first_delay_ms=1), _sender=flaky)
        with pytest.raises(ConnectionError):
            _run(pkg, pw)
        return len(calls)

    assert _each(case) == (3, 3)


class _Sink(http.server.BaseHTTPRequestHandler):
    received: list = []
    fail_first: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        if self.fail_first:
            self.fail_first.pop()
            self.send_response(503)
            self.end_headers()
            return
        self.received.append((self.path, self.headers.get("Content-Type"), json.loads(body)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.mark.timeout(60)
def test_http_write_to_a_local_server_retries_a_503():
    srv = _serve(_Sink)
    port = srv.server_address[1]
    try:
        def case(pkg, pw):
            _Sink.received = []
            _Sink.fail_first = [1]
            t = pw.debug.table_from_markdown(
                """
                a | b
                1 | x
                """
            )
            pw.io.http.write(t, f"http://127.0.0.1:{port}/in", n_retries=1,
                             retry_policy=pw.io.http.RetryPolicy(first_delay_ms=5),
                             request_timeout_ms=10_000, headers={"X-T": "1"})
            _run(pkg, pw)
            return [(p, c, {k: v for k, v in b.items() if k != "time"})
                    for p, c, b in _Sink.received]

        j, t = _each(case)
        assert t == [("/in", "application/json", {"a": 1, "b": "x", "diff": 1})]
        assert t == j
    finally:
        srv.shutdown()
        srv.server_close()


class _Chunks(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for part in (b"al", b"pha|be", b"ta|", b"gamma"):
            self.wfile.write(b"%x\r\n%s\r\n" % (len(part), part))
            self.wfile.flush()
        self.wfile.write(b"0\r\n\r\n")

    def log_message(self, *a):
        pass


@pytest.mark.timeout(60)
def test_http_streaming_subject_against_a_local_server():
    srv = _serve(_Chunks)
    port = srv.server_address[1]
    try:
        def case(pkg, pw):
            subj = pw.io.http.HttpStreamingSubject(
                f"http://127.0.0.1:{port}/s", delimiter="|",
                response_mapper=lambda b: b.upper())
            t = pw.io.python.read(subj, schema=pw.schema_from_types(data=bytes))
            return sorted(r[0] for r in _rows(pkg, t)[0].values())

        j, t = _each(case)
        assert t == [b"ALPHA", b"BETA", b"GAMMA"] == j
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_endpoint_examples_and_streaming_subject(pkg):
    h = _http(pkg)
    ex = h.EndpointExamples()
    ex.add_example("default", "the default", {"q": "hi"})
    with pytest.raises(ValueError):
        ex.add_example("default", "dup", {})
    subj = h.HttpStreamingSubject("http://localhost:1/never",
                                  sender=lambda *a, **k: iter([b"x"]))
    assert hasattr(subj, "run")


def test_http_read_persistent_id_raises_in_the_port():
    """``persistent_id=`` raised until persistence came to the port; now
    the reader's offset is its consumed bytes and row counter."""
    import pathway_tpu_torch as pw

    pw.clear_graph()
    pw.io.http.read("http://x", format="raw", persistent_id="p")
    (conn,) = pw.G.connectors
    assert conn.persistent_id == "p"
    assert pw.persistence.get_persistent_sources() == {"p": conn}
    conn.seek_offset((12, 3))
    assert conn.current_offset() == (12, 3)
    pw.clear_graph()


def test_http_names_equal_jax():
    j = {n for n in dir(_http("jax")) if not n.startswith("_")}
    t = {n for n in dir(_http("torch")) if not n.startswith("_")}
    for name in ("read", "write", "RetryPolicy", "HttpStreamingSubject", "rest_connector",
                 "PathwayWebserver", "EndpointExamples", "EndpointDocumentation"):
        assert name in j and name in t, name
