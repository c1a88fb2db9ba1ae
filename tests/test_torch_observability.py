"""The port's observability surface held against the JAX package's (the
bars are ``tests/test_trace.py``'s capture cases, ``test_debug_monitor_matrix.py``,
``test_observability.py`` and ``test_http_health.py``):

* ``internals/profiling.capture_trace`` on ``torch.profiler`` on the CPU:
  refused without a directory (JAX's shape), a Chrome trace naming the
  ops that ran, the 1..10,000 ms clamp, bad values, one capture at a time
  with distinct directories, an error (not a raise) when another profiler
  is active;
* ``GET /debug/profile`` on a ``BaseRestServer`` with and without
  ``profile_dir``, beside JAX's route;
* ``MetricsServer``: the health pair in both states, ``/metrics`` (and its
  aliases) with the scheduler gauges equal to JAX's text and the registry
  families; ``pw.run(with_http_server=True)`` serving a live run;
* the monitor levels: resolution equal to JAX's, the dashboard's tables,
  start and stop with ``pw.run``, the ``ImportError`` without ``rich``;
* the CLI's ``stats``, ``watch`` and ``fleet stats`` / ``watch`` /
  ``serve`` against fake servers, their output equal to JAX's ``click``
  CLI on the same replies, and the commands not ported.

Every wait is bounded."""

import contextlib
import http.server
import io
import json
import re
import socketserver
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pathway_tpu_torch as TPW
from pathway_tpu_torch import cli as tcli
from pathway_tpu_torch.engine import probes as tprobes
from pathway_tpu_torch.internals import http_server as th
from pathway_tpu_torch.internals import monitoring as tmon
from pathway_tpu_torch.internals import profiling as tprof
from pathway_tpu_torch.internals import run as trun


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers)


# ------------------------------------------------------------------ profiling

def test_capture_trace_disabled_has_jax_shape():
    from pathway_tpu.internals import profiling as jprof

    got, want = tprof.capture_trace(100), jprof.capture_trace(100)
    assert set(got) == set(want) == {"error"}
    assert got["error"].startswith("profiling disabled") and want["error"].startswith(
        "profiling disabled")
    assert "/debug/profile" in got["error"]


def test_capture_trace_enabled_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)

    def work(_s):
        for _ in range(3):
            torch.mm(x, x)

    out = tprof.capture_trace(50, profile_dir=str(tmp_path), sleep=work)
    assert "error" not in out, out
    assert out["ms"] == 50.0 and out["activities"] == ["CPU"]
    assert out["trace_dir"].startswith(str(tmp_path))
    assert re.search(r"profile-\d+-\d{3}$", out["trace_dir"])
    trace = json.loads(open(out["trace"]).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


@pytest.mark.parametrize("ms,want", [(0, 1.0), (-5, 1.0), ("250", 250.0), (3.6e6, 10_000.0)])
def test_capture_trace_clamps(tmp_path, ms, want):
    slept = []
    out = tprof.capture_trace(ms, profile_dir=str(tmp_path), sleep=slept.append)
    assert out["ms"] == want and slept == [want / 1e3]


def test_capture_trace_bad_ms_is_an_error_not_a_raise(tmp_path):
    assert tprof.capture_trace("soon", profile_dir=str(tmp_path)) == {
        "error": "bad ms value: 'soon'"}


def test_capture_trace_serializes_concurrent_captures(tmp_path):
    spans, outs = [], []
    lock = threading.Lock()

    def sleeper(s):
        t0 = time.monotonic()
        time.sleep(0.05)
        with lock:
            spans.append((t0, time.monotonic()))

    threads = [threading.Thread(target=lambda: outs.append(
        tprof.capture_trace(5, profile_dir=str(tmp_path), sleep=sleeper))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(outs) == 3 and all("trace_dir" in o for o in outs)
    assert len({o["trace_dir"] for o in outs}) == 3
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), "captures overlapped"


def test_capture_trace_inside_another_profiler_returns_an_error(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = tprof.capture_trace(5, profile_dir=str(tmp_path), sleep=lambda s: None)
    assert set(out) == {"error"}


def _rest(pkg, **kw):
    if pkg == "torch":
        from pathway_tpu_torch.xpacks.llm.servers import BaseRestServer
    else:
        from pathway_tpu.xpacks.llm.servers import BaseRestServer
    srv = BaseRestServer("127.0.0.1", 0, **kw)
    srv.start_observability_endpoints()
    srv.webserver.start()
    return srv, f"http://127.0.0.1:{srv.webserver.port}"


def test_debug_profile_route_disabled_equals_jax_shape():
    tsrv, tbase = _rest("torch")
    _jsrv, jbase = _rest("jax")
    try:
        ts, tb, _ = _get(tbase + "/debug/profile?ms=10")
        js, jb, _ = _get(jbase + "/debug/profile?ms=10")
        assert ts == js == 200
        got, want = json.loads(tb), json.loads(jb)
        assert set(got) == set(want) == {"error"}
        assert got["error"].startswith("profiling disabled")
    finally:
        tsrv.webserver.stop()


def test_debug_profile_route_enabled_writes_a_trace(tmp_path):
    srv, base = _rest("torch", profile_dir=str(tmp_path))
    try:
        status, body, _ = _get(base + "/debug/profile?ms=20")
        assert status == 200
        out = json.loads(body)
        assert out["ms"] == 20.0 and out["trace_dir"].startswith(str(tmp_path))
        assert json.loads(open(out["trace"]).read())["traceEvents"] is not None
        # the server answers while a capture runs
        got = {}
        t = threading.Thread(target=lambda: got.setdefault(
            "p", _get(base + "/debug/profile?ms=1500")))
        t.start()
        time.sleep(0.3)
        assert _get(base + "/healthz")[0] == 200
        t.join(30)
        assert got["p"][0] == 200 and json.loads(got["p"][1])["ms"] == 1500.0
    finally:
        srv.webserver.stop()


# ---------------------------------------------------------------- MetricsServer

@pytest.fixture
def metrics_server():
    ready = {"v": False}
    srv = th.MetricsServer(stats=None, port=0, ready_check=lambda: ready["v"]).start()
    try:
        yield srv, ready
    finally:
        srv.stop()


def test_metrics_server_healthz_always_live(metrics_server):
    srv, _ = metrics_server
    status, body, _ = _get(f"http://127.0.0.1:{srv.port}/healthz")
    assert (status, body) == (200, b"ok\n")


def test_metrics_server_readyz_both_states(metrics_server):
    srv, ready = metrics_server
    base = f"http://127.0.0.1:{srv.port}"
    status, body, headers = _get(base + "/readyz")
    assert status == 503 and b"not ready" in body and headers.get("Retry-After") == "1"
    ready["v"] = True
    assert _get(base + "/readyz")[:2] == (200, b"ready\n")
    srv.ready_check = lambda: 1 / 0  # a crashing probe fails closed
    assert _get(base + "/readyz")[0] == 503
    assert _get(base + "/nope")[0] == 404


def test_metrics_server_default_readiness_is_stats_snapshot():
    class _Stats:
        def snapshot(self):
            return {"current_time": 0}

    assert th.MetricsServer(stats=None, port=0)._ready() is False
    assert th.MetricsServer(stats=_Stats(), port=0)._ready() is True
    assert th.MetricsServer(stats=None).port == th.BASE_PORT == 20000
    assert th.MetricsServer(stats=None, process_id=3).port == 20003


def _stats(mod):
    stats = mod.SchedulerStats()
    stats.record_step(1, "select", 10, 10, 0.001)
    stats.record_step(7, "reduce", 5, 1, 0.002)
    stats.record_connector_commit(99, "CsvReader[input]", 42)
    return stats


def _no_lag(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith(("pathway_operator_lag_seconds", "pathway_uptime_seconds"))]


def test_metrics_from_stats_equals_jax():
    from pathway_tpu.engine import probes as jprobes
    from pathway_tpu.internals import http_server as jh

    snap = _stats(tprobes).snapshot()
    text = th.metrics_from_stats(snap)
    assert _no_lag(text) == _no_lag(jh.metrics_from_stats(snap))
    assert 'pathway_operator_rows_in_total{operator="select"} 10' in text
    assert 'pathway_connector_commits_total{connector="CsvReader[input]"} 1' in text
    assert _no_lag(jh.metrics_from_stats(_stats(jprobes).snapshot())) == _no_lag(
        th.metrics_from_stats(snap))


def test_metrics_server_serves_scheduler_gauges_and_registry():
    srv = th.MetricsServer(_stats(tprobes), port=0).start()
    try:
        for path in ("/metrics", "/", "/status"):
            status, body, headers = _get(f"http://127.0.0.1:{srv.port}{path}")
            text = body.decode()
            assert status == 200 and headers["Content-Type"].startswith("text/plain")
            assert 'pathway_operator_rows_out_total{operator="reduce"} 1' in text
            assert "# TYPE pathway_tpu_requests_routed counter" in text
            assert text.rstrip("\n").endswith("# EOF")
    finally:
        srv.stop()


def _live_program(pw, n_rows=3):
    """A streaming program whose subject waits on an event after its
    rows: the run stays live until the event is set."""
    release = threading.Event()

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(n_rows):
                self.next(a=i)
            self.commit()
            release.wait(30)

    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(a=int))
    seen = []
    pw.io.subscribe(t.select(b=t.a * 2), on_change=lambda key, row, time, is_addition:
                    seen.append(row["b"]))
    return release, seen


@pytest.mark.timeout(120)
def test_run_with_http_server_serves_the_live_run():
    TPW.clear_graph()
    release, seen = _live_program(TPW)
    got, err = {}, []

    def body():
        try:
            TPW.run(with_http_server=True, config=TPW.EngineConfig(metrics_first_port=0))
        except BaseException as exc:  # noqa: BLE001
            err.append(exc)

    runner = threading.Thread(target=body, daemon=True)
    runner.start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline and (trun.METRICS_SERVER is None or len(seen) < 3):
            time.sleep(0.02)
        srv = trun.METRICS_SERVER
        assert srv is not None and sorted(seen) == [0, 2, 4]
        base = f"http://127.0.0.1:{srv.port}"
        got["metrics"] = _get(base + "/metrics")
        got["healthz"] = _get(base + "/healthz")
        got["readyz"] = _get(base + "/readyz")
    finally:
        release.set()
        runner.join(60)
    assert not err and not runner.is_alive()
    status, body, _ = got["metrics"]
    text = body.decode()
    assert status == 200 and "pathway_logical_time" in text
    assert "pathway_connector_rows_read_total" in text and "pathway_tpu_op_rows" in text
    assert got["healthz"][0] == got["readyz"][0] == 200
    assert trun.METRICS_SERVER is None  # stopped with the run
    with pytest.raises(OSError):
        urllib.request.urlopen(base + "/healthz", timeout=2)
    TPW.clear_graph()


def test_engine_config_metrics_port_default_is_jax_base_port():
    assert TPW.EngineConfig().metrics_first_port == 20000


def test_set_license_key_and_monitoring_config():
    from pathway_tpu_torch.internals import config

    try:
        TPW.set_license_key("k-1")
        TPW.set_monitoring_config(server_endpoint="http://collector:4317")
        assert (config.license_key, config.monitoring_server) == ("k-1", "http://collector:4317")
    finally:
        TPW.set_license_key(None)
        TPW.set_monitoring_config(server_endpoint=None)
    assert (config.license_key, config.monitoring_server) == (None, None)


# ------------------------------------------------------------------- monitor

@pytest.mark.parametrize("interactive", [True, False])
def test_monitoring_level_resolution_equals_jax(interactive, monkeypatch):
    from pathway_tpu.internals.monitoring import MonitoringLevel as JL
    from pathway_tpu.internals.monitoring import _resolve

    monkeypatch.setattr(sys.stderr, "isatty", lambda: interactive)
    for level in [None, *tmon.MonitoringLevel]:
        want = _resolve(None if level is None else JL[level.name], interactive=interactive)
        assert tmon.resolve_level(level).name == want.name
    assert tmon.resolve_level("all") is tmon.MonitoringLevel.ALL


def test_stats_monitor_renders():
    stats = tprobes.SchedulerStats()
    stats.record_step(1, "input:csv", 3, 3, 0.0)
    stats.record_step(2, "select", 3, 3, 0.0)
    assert tmon.StatsMonitor(stats, tmon.MonitoringLevel.ALL)._render().row_count == 2
    assert tmon.StatsMonitor(stats, tmon.MonitoringLevel.IN_OUT)._render().row_count == 1
    tprobes.REGISTRY.reset()
    try:
        tprobes.record_prefix("requests", 2)
        tprobes.record_prefix("hit_tokens", 8)
        tprobes.record_prefix("miss_tokens", 8)
        tprobes.observe_latency("ttft_seconds", 0.05, "decode")
        panel = tmon.StatsMonitor(stats, tmon.MonitoringLevel.ALL)._serving_panel()
        assert panel is not None and panel.row_count >= 3
        from rich.console import Console

        buf = io.StringIO()
        Console(file=buf, width=120).print(
            tmon.StatsMonitor(stats, tmon.MonitoringLevel.ALL)._render_dashboard())
        assert "prefix hit rate" in buf.getvalue() and "select" in buf.getvalue()
    finally:
        tprobes.REGISTRY.reset()


@pytest.mark.timeout(60)
def test_maybe_start_monitor_starts_and_stops(monkeypatch):
    monkeypatch.setattr(sys.stderr, "isatty", lambda: False)
    stats = tprobes.SchedulerStats()
    assert tmon.maybe_start_monitor(stats, tmon.MonitoringLevel.NONE) is None
    assert tmon.maybe_start_monitor(stats, None) is None
    frames = []
    monkeypatch.setattr(tmon.StatsMonitor, "_loop", lambda self: (
        frames.append(self._render_dashboard()), self._stop.wait(10)))
    mon = tmon.maybe_start_monitor(stats, "in_out")
    assert mon is not None and mon.level is tmon.MonitoringLevel.IN_OUT
    mon.stop()
    assert mon._thread is None and len(frames) == 1


def test_dashboard_without_rich_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "rich.live", None)
    with pytest.raises(ImportError, match="rich"):
        tmon.maybe_start_monitor(tprobes.SchedulerStats(), tmon.MonitoringLevel.ALL)
    TPW.clear_graph()
    t = TPW.debug.table_from_rows(TPW.schema_from_types(a=int), [(1,)])
    TPW.io.subscribe(t, on_change=lambda **kw: None)
    with pytest.raises(ImportError, match="rich"):
        TPW.run(monitoring_level=TPW.MonitoringLevel.ALL)
    TPW.clear_graph()


def test_port_modules_import_no_rich_or_click():
    import ast
    from pathlib import Path

    root = Path(TPW.__file__).resolve().parent
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:  # module level only
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            assert not any(n.split(".")[0] in ("rich", "click") for n in names), path


# ------------------------------------------------------------------------ CLI

class _Fake(http.server.BaseHTTPRequestHandler):
    replies: dict = {}

    def do_GET(self):
        body = json.dumps(self.replies.get(self.path, {})).encode()
        self.send_response(200 if self.path in self.replies else 404)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def fake():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Fake)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def _port_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = tcli.main(argv)
    return code, buf.getvalue()


def _jax_cli(argv):
    from click.testing import CliRunner

    from pathway_tpu.cli import cli

    res = CliRunner().invoke(cli, argv)
    return res.exit_code, res.output


STATS = {
    "serving": {"latency": {"e2e_seconds": {"p50_ms": 12.5, "p95_ms": 20.0, "count": 3}},
                "prefix": {"hit_rate": 0.5, "requests": 2}, "occupancy": {"srv-1": 0.75},
                "lanes": {"decode": 2}, "kv_parked_bytes": {"s": 0, "t": 8}},
    "hbm": {"current_bytes": {"kv_pool": 1024}, "device_bytes": {"0": {"kv_pool": 1024}}},
    "scheduler": {"current_time": 4, "epochs_total": 2, "uptime_s": 1.5, "finished": False},
    "slo": {"objectives": {"ttft_p95": {"value": 0.5, "unit": "s", "alert": True,
                                        "kind": "ceiling", "threshold": 0.2,
                                        "burn_fast": 3.0, "burn_slow": 2.5, "breaches": 4}},
            "alerting": ["ttft_p95"]},
}
FLEET = {"size": 2, "min": 1, "max": 4, "burn": 0.25, "respawns": 1,
         "replicas": {"replica-0": {"kind": "http", "consecutive_failures": 0},
                      "replica-2": {"kind": "http", "consecutive_failures": 1}},
         "events": [["spawn", "replica-0"], ["drain", "replica-1"], ["respawn", "replica-2"]],
         "ring_members": ["replica-0", "replica-2"]}


def _stamp(text):
    return re.sub(r"\[\d\d:\d\d:\d\d\]", "[T]", text)


def test_cli_stats_against_a_server_equals_jax(fake):
    _Fake.replies = {"/v1/statistics": STATS}
    for argv in (["stats", "--url", fake], ["stats", "--url", fake + "/", "--as-json"]):
        code, out = _port_cli(argv)
        assert (code, out) == _jax_cli(argv)
    code, out = _port_cli(["stats", "--url", fake])
    assert "latency/e2e_seconds (ms)" in out and "hbm_bytes/device=0" in out
    assert "kv_parked_bytes" in out and "  t  8" in out


def test_cli_stats_local_registry():
    tprobes.REGISTRY.reset()
    try:
        tprobes.record_prefix("requests", 2)
        tprobes.record_prefix("hit_tokens", 8)
        tprobes.record_prefix("miss_tokens", 8)
        tprobes.observe_latency("e2e_seconds", 0.12, "decode")
        code, out = _port_cli(["stats", "--as-json"])
        assert code == 0 and json.loads(out)["serving"]["prefix"]["hit_rate"] == 0.5
        code, out = _port_cli(["stats"])
        assert code == 0 and "prefix" in out and "latency/e2e_seconds" in out
    finally:
        tprobes.REGISTRY.reset()


def test_cli_watch_against_a_server_equals_jax(fake):
    _Fake.replies = {"/v1/statistics": STATS}
    argv = ["watch", "--url", fake, "--iterations", "2", "--interval", "0.01"]
    code, out = _port_cli(argv)
    jcode, jout = _jax_cli(argv)
    assert code == jcode == 0 and _stamp(out) == _stamp(jout)
    assert out.count("ALERT ttft_p95") == 2 and "lanes: decode=2" in out
    code, _ = _port_cli(argv + ["--fail-on-alert"])
    assert code == 1 == _jax_cli(argv + ["--fail-on-alert"])[0]
    _Fake.replies = {"/v1/statistics": {"slo": {}, "serving": {}}}
    code, out = _port_cli(argv[:3] + ["--iterations", "1"])
    assert code == 0 and "no SLO objectives configured" in out


def test_cli_fleet_stats_and_watch_equal_jax(fake):
    _Fake.replies = {"/v1/fleet": FLEET}
    for argv in (["fleet", "stats", "--url", fake], ["fleet", "stats", "--url", fake,
                                                     "--as-json"]):
        assert _port_cli(argv) == _jax_cli(argv)
    argv = ["fleet", "watch", "--url", fake, "--iterations", "2", "--interval", "0.01"]
    code, out = _port_cli(argv)
    jcode, jout = _jax_cli(argv)
    assert code == jcode == 0 and _stamp(out) == _stamp(jout)
    assert "members=replica-0,replica-2" in out


def test_cli_fleet_serve_is_off_by_default(capsys):
    from pathway_tpu_torch import serving

    assert tcli.main(["fleet", "serve", "python3", "x.py"]) == 2
    assert "--fleet" in capsys.readouterr().err
    assert not serving.fleet_enabled()


@pytest.mark.parametrize("name", ["spawn", "spawn-from-env", "tune", "airbyte"])
def test_cli_commands_not_ported_exit_nonzero(name, capsys, tmp_path):
    """No command is left unported: ``tune`` with an unknown profile exits
    2 (JAX's code), ``airbyte`` with an unknown subcommand is a usage
    error (2), and ``spawn`` / ``spawn-from-env`` with a program file that
    does not exist fail their child, exit code 1. None prints "not
    ported"."""
    if name == "tune":
        assert tcli.main([name, "anything"]) == 2
        assert "unknown profile" in capsys.readouterr().err
    elif name == "airbyte":
        with pytest.raises(SystemExit) as exc:
            tcli.main([name, "anything"])
        assert exc.value.code == 2
        assert "not ported" not in capsys.readouterr().err
    else:
        assert tcli.main([name, str(tmp_path / "missing.py")]) == 1
        assert "not ported" not in capsys.readouterr().err


def test_cli_module_entry_point_and_script():
    import subprocess
    from pathlib import Path

    root = Path(TPW.__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "fleet", "serve", "p"],
                          cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "fleet serving is off" in proc.stderr
    assert 'pathway-tpu-torch = "pathway_tpu_torch.cli:main"' in (
        root / "pyproject.toml").read_text()


def test_prepare_opens_one_empty_session_once(tmp_path, monkeypatch):
    from pathway_tpu_torch.xpacks.llm.servers import BaseRestServer

    sessions = []
    orig = torch.profiler.profile

    def counting(*a, **kw):
        sessions.append(kw.get("activities"))
        return orig(*a, **kw)

    monkeypatch.setattr(tprof, "_prepared", False)
    monkeypatch.setattr(torch.profiler, "profile", counting)
    BaseRestServer("127.0.0.1", 0)  # no profile_dir: nothing
    assert sessions == []
    BaseRestServer("127.0.0.1", 0, profile_dir=str(tmp_path))
    BaseRestServer("127.0.0.1", 0, profile_dir=str(tmp_path))
    assert len(sessions) == 1 and tprof._prepared


# ------------------------------------------------- the occupancy gauge

_OCC_CFG = None


def _occ_chat(paged: bool):
    from pathway_tpu_torch.models import decoder as TD
    from pathway_tpu_torch.xpacks.llm import DecoderChat

    global _OCC_CFG
    if _OCC_CFG is None:
        cfg = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                               intermediate=64, max_position=128, dtype=torch.float32)
        _OCC_CFG = (cfg, TD.init_params(torch.Generator().manual_seed(0), cfg))
    cfg, params = _OCC_CFG
    tok = type("Tok", (), {"eos_id": None,
                           "encode": staticmethod(lambda s: [ord(c) % 96 + 1 for c in s]),
                           "decode": staticmethod(lambda ids: "".join(
                               chr(int(i) % 96 + 32) for i in ids))})()
    kw = dict(paged_kv=True, paged_kv_block=8) if paged else {}
    return DecoderChat(params=params, cfg=cfg, tokenizer=tok, max_new_tokens=8,
                       max_prompt_tokens=32, continuous=True, n_slots=4, chunk_steps=4,
                       pipeline_depth=2, prefill_chunk=8, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("burst", [24, 32, 48])
def test_occupancy_gauge_equals_server_occupancy_after_a_burst(burst, paged):
    """After a burst the loop goes idle and writes the gauge, so
    ``serving_snapshot()['occupancy']`` holds ``round(occupancy(), 4)``
    (phase 11 (a)'s bar, with its bounded wait). The gauge is also written
    on the 1st and every 8th chunk before that chunk's useful steps are
    counted: a burst whose last chunk is one of those must still be
    published when the loop goes idle."""
    chat = _occ_chat(paged)
    try:
        srv = chat.server
        prompts = [f"request {k:02d} " + "x" * (k % 7) for k in range(burst)]
        reqs = chat.submit_batch(prompts)
        for r in reqs:
            assert r.done.wait(120.0)
        assert all(len(r.tokens) == 8 for r in reqs)
        end = time.monotonic() + 10.0
        want = None
        while time.monotonic() < end:
            want = round(srv.occupancy(), 4)
            if tprobes.serving_snapshot()["occupancy"].get(srv._trace_tag) == want:
                break
            time.sleep(0.005)
        assert tprobes.serving_snapshot()["occupancy"].get(srv._trace_tag) == want
    finally:
        chat.close()


def test_occupancy_gauge_republished_when_the_last_chunk_was_published_early():
    """The idle write keys on the steps it published as well as the chunk:
    a last chunk numbered 8k + 1 wrote the gauge before its own useful
    steps were counted, and the idle loop must write it again."""
    chat = _occ_chat(False)
    try:
        srv = chat.server
        reqs = chat.submit_batch(["one", "two"])
        for r in reqs:
            assert r.done.wait(60.0)
        end = time.monotonic() + 10.0
        while time.monotonic() < end and tprobes.serving_snapshot()["occupancy"].get(
                srv._trace_tag) != round(srv.occupancy(), 4):
            time.sleep(0.005)
        # the state a publish on chunk 8k + 1 leaves: the gauge written
        # with the steps before that chunk's lanes were counted
        srv._publish_occupancy(np.zeros(srv.n_slots, dtype=bool))
        srv.stats["steps"] += 1
        srv.wake.set()
        end = time.monotonic() + 10.0
        while time.monotonic() < end and tprobes.serving_snapshot()["occupancy"].get(
                srv._trace_tag) != round(srv.occupancy(), 4):
            time.sleep(0.005)
        assert tprobes.serving_snapshot()["occupancy"].get(srv._trace_tag) == round(
            srv.occupancy(), 4)
    finally:
        chat.close()
