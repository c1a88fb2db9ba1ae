"""The port's OpenTelemetry exporter (``internals/telemetry.py``, the
serving-span export of ``engine/tracing.py`` and ``pw.run``'s run span)
against the JAX package's (``tests/test_misc_parity.py::
test_telemetry_noop_and_xpacks`` is the bar).

The OpenTelemetry API is installed here but its SDK is not, so the export
runs against a recording fake of the SDK modules, installed in
``sys.modules`` for one test: both packages export through the same fake,
and the recorded spans (names, attributes, events) must be equal."""

import importlib.machinery
import sys
import threading
import types
from contextlib import contextmanager

import pytest

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu.engine import tracing as jtracing
from pathway_tpu.internals.telemetry import Telemetry as JTelemetry
from pathway_tpu_torch.engine import tracing as ttracing
from pathway_tpu_torch.internals import config as tconfig
from pathway_tpu_torch.internals.telemetry import Telemetry, get_imported_xpacks

ENDPOINT = "localhost:4317"


class _Span:
    def __init__(self, name):
        self.name, self.attributes, self.events = name, {}, []

    def set_attribute(self, k, v):
        self.attributes[k] = v

    def add_event(self, name, attributes):
        self.events.append((name, dict(attributes)))


class Recorder:
    """The fake SDK's one shared state: every finished span, in order, and
    the providers' lifecycles."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.stack: list[_Span] = []
        self.endpoints: list[str] = []
        self.shutdowns = 0
        self.lock = threading.Lock()


def install_fake_sdk(monkeypatch) -> Recorder:
    rec = Recorder()

    class Tracer:
        @contextmanager
        def start_as_current_span(self, name):
            span = _Span(name)
            rec.stack.append(span)
            try:
                yield span
            finally:
                rec.stack.pop()
                with rec.lock:
                    rec.spans.append(span)

    class TracerProvider:
        def __init__(self, resource=None):
            self.resource = resource

        def add_span_processor(self, p):
            self.processor = p

        def shutdown(self):
            rec.shutdowns += 1

    class Resource:
        @staticmethod
        def create(attrs):
            return dict(attrs)

    class OTLPSpanExporter:
        def __init__(self, endpoint):
            rec.endpoints.append(endpoint)

    class BatchSpanProcessor:
        def __init__(self, exporter):
            self.exporter = exporter

    trace = types.ModuleType("opentelemetry.trace")
    trace.get_tracer = lambda name, tracer_provider=None: Tracer()
    trace.get_current_span = lambda: rec.stack[-1] if rec.stack else _Span("none")
    otel = types.ModuleType("opentelemetry")
    otel.trace = trace
    mods = {
        "opentelemetry": otel,
        "opentelemetry.trace": trace,
        "opentelemetry.sdk": types.ModuleType("opentelemetry.sdk"),
        "opentelemetry.sdk.resources": types.ModuleType("opentelemetry.sdk.resources"),
        "opentelemetry.sdk.trace": types.ModuleType("opentelemetry.sdk.trace"),
        "opentelemetry.sdk.trace.export": types.ModuleType("opentelemetry.sdk.trace.export"),
        "opentelemetry.exporter": types.ModuleType("opentelemetry.exporter"),
        "opentelemetry.exporter.otlp": types.ModuleType("opentelemetry.exporter.otlp"),
        "opentelemetry.exporter.otlp.proto": types.ModuleType("opentelemetry.exporter.otlp.proto"),
        "opentelemetry.exporter.otlp.proto.grpc": types.ModuleType(
            "opentelemetry.exporter.otlp.proto.grpc"),
        "opentelemetry.exporter.otlp.proto.grpc.trace_exporter": types.ModuleType(
            "opentelemetry.exporter.otlp.proto.grpc.trace_exporter"),
    }
    mods["opentelemetry.sdk.resources"].Resource = Resource
    mods["opentelemetry.sdk.trace"].TracerProvider = TracerProvider
    mods["opentelemetry.sdk.trace.export"].BatchSpanProcessor = BatchSpanProcessor
    mods["opentelemetry.exporter.otlp.proto.grpc.trace_exporter"].OTLPSpanExporter = (
        OTLPSpanExporter)
    for name, mod in mods.items():
        mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
        monkeypatch.setitem(sys.modules, name, mod)
    return rec


@pytest.fixture
def endpoints():
    """The collector endpoint set in both packages for one test, and the
    exporters' cached Telemetry dropped before and after."""
    jtracing._telemetry = None
    ttracing._telemetry = None
    JPW.set_monitoring_config(server_endpoint=ENDPOINT)
    TPW.set_monitoring_config(server_endpoint=ENDPOINT)
    yield
    JPW.set_monitoring_config(server_endpoint=None)
    TPW.set_monitoring_config(server_endpoint=None)
    jtracing._telemetry = None
    ttracing._telemetry = None


def _recorded(rec):
    return [(s.name, s.attributes, s.events) for s in rec.spans]


def test_telemetry_noop_and_xpacks():
    from pathway_tpu_torch.xpacks import llm  # noqa: F401

    for cls in (Telemetry, JTelemetry):
        t = cls(endpoint=None)
        assert not t.enabled
        with t.span("x", {"k": 1}) as s:
            assert s is None
        t.event("e")
        t.shutdown()
    xp = get_imported_xpacks()
    assert "llm" in xp and "connectors" in xp


def test_create_reads_the_monitoring_config_not_the_environment(monkeypatch):
    monkeypatch.setenv("PATHWAY_MONITORING_SERVER", ENDPOINT)
    assert tconfig.monitoring_server is None
    assert Telemetry.create().endpoint is None
    assert ttracing._get_telemetry() is None
    TPW.set_monitoring_config(server_endpoint=ENDPOINT)
    try:
        assert Telemetry.create().endpoint == ENDPOINT
    finally:
        TPW.set_monitoring_config(server_endpoint=None)


def test_endpoint_without_the_sdk_is_a_noop(endpoints):
    """The API is importable here and the SDK is not: no tracer, no
    error, and a span export does nothing."""
    t = Telemetry(ENDPOINT)
    assert not t.enabled
    ttracing._export_otel({"id": 1, "server": "s", "kind": "decode",
                           "metrics": {}, "events": []})


SPAN = {
    "kind": "decode", "id": 7, "server": "srv-1",
    "metrics": {"ttft_ms": 1.5, "e2e_ms": 9.25, "tokens": 4, "queue_wait_ms": 0.5},
    "events": [{"name": "enqueue", "t_ms": 0.0}, {"name": "admit", "t_ms": 0.5},
               {"name": "first_token", "t_ms": 1.5}, {"name": "drain", "t_ms": 9.25}],
}


def test_same_span_dict_exports_the_same_span(monkeypatch, endpoints):
    rec = install_fake_sdk(monkeypatch)
    jtracing._export_otel(SPAN)
    jax_spans = _recorded(rec)
    rec.spans.clear()
    ttracing._export_otel(SPAN)
    port_spans = _recorded(rec)
    assert port_spans == jax_spans
    ((name, attrs, events),) = port_spans
    assert name == "pathway_tpu.decode"
    assert attrs == {"pathway_tpu.request_id": "7", "pathway_tpu.server": "srv-1",
                     "pathway_tpu.ttft_ms": 1.5, "pathway_tpu.e2e_ms": 9.25,
                     "pathway_tpu.tokens": 4, "pathway_tpu.queue_wait_ms": 0.5}
    assert [e[0] for e in events] == ["enqueue", "admit", "first_token", "drain"]
    assert rec.endpoints == [ENDPOINT, ENDPOINT]


def test_exporter_rebuilt_when_the_endpoint_changes(monkeypatch, endpoints):
    rec = install_fake_sdk(monkeypatch)
    first = ttracing._get_telemetry()
    assert first is ttracing._get_telemetry() and first.enabled
    TPW.set_monitoring_config(server_endpoint="localhost:9999")
    second = ttracing._get_telemetry()
    assert second is not first and second.endpoint == "localhost:9999"
    assert rec.endpoints == [ENDPOINT, "localhost:9999"]


def _program(pw):
    t = pw.debug.table_from_markdown(
        """
        a | b
        1 | 2
        3 | 4
        """
    )
    r = t.select(s=t.a + t.b).filter(pw.this.s > 3)
    seen = []
    pw.io.subscribe(r, on_change=lambda key, row, time, is_addition: seen.append(row))
    pw.run()
    return seen


def test_run_span_equals_jax(monkeypatch, endpoints):
    """The same small program under one fake SDK: one ``pathway-tpu.run``
    span in each package, with JAX's attribute keys and the same xpacks,
    and its provider shut down at the run's end."""
    rec = install_fake_sdk(monkeypatch)
    import pathway_tpu.xpacks.llm  # noqa: F401
    import pathway_tpu_torch.xpacks.llm  # noqa: F401

    JPW.clear_graph()
    j_rows = _program(JPW)
    jax_spans = _recorded(rec)
    rec.spans.clear()
    TPW.clear_graph()
    t_rows = _program(TPW)
    port_spans = _recorded(rec)
    assert t_rows == j_rows == [{"s": 7}]
    assert [s[0] for s in port_spans] == [s[0] for s in jax_spans] == ["pathway-tpu.run"]
    (_, jattrs, _), (_, tattrs, _) = jax_spans[0], port_spans[0]
    assert set(tattrs) == set(jattrs) == {"operators", "xpacks"}
    assert tattrs["xpacks"] == jattrs["xpacks"] == "connectors,llm"
    assert tattrs["operators"] >= 1
    assert rec.shutdowns == 2


def test_serving_spans_exported_once_each(monkeypatch, endpoints):
    """A CPU DecoderChat burst with the exporter on: one span per finished
    request, with JAX's name and attribute keys, and the events of the
    ring's copy."""
    import torch

    from pathway_tpu_torch.models import decoder as TD
    from pathway_tpu_torch.xpacks.llm import DecoderChat
    from tests.utils import ToyCharTokenizer

    rec = install_fake_sdk(monkeypatch)
    cfg = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                           intermediate=64, max_position=128, dtype=torch.float32)
    params = TD.init_params(torch.Generator().manual_seed(0), cfg)
    chat = DecoderChat(params=params, cfg=cfg, tokenizer=ToyCharTokenizer(32),
                       max_new_tokens=4, max_prompt_tokens=32, continuous=True,
                       n_slots=2, chunk_steps=4, prefill_chunk=8, device="cpu")
    try:
        reqs = chat.submit_batch([f"q{i}" for i in range(5)])
        for r in reqs:
            assert r.done.wait(60)
    finally:
        chat.close()
    decode = [s for s in rec.spans if s.name == "pathway_tpu.decode"]
    assert len(decode) == 5
    ids = sorted(s.attributes["pathway_tpu.request_id"] for s in decode)
    assert len(set(ids)) == 5
    ring = {str(t["id"]): t for t in chat.recent_traces()}
    for s in decode:
        span = ring[s.attributes["pathway_tpu.request_id"]]
        assert s.attributes["pathway_tpu.server"] == str(span["server"])
        assert {f"pathway_tpu.{k}" for k in span["metrics"]} <= set(s.attributes)
        assert [e[0] for e in s.events] == [e["name"] for e in span["events"]]
