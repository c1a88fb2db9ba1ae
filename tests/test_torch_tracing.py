"""The port's request spans (``engine/tracing.py``) against the JAX
package's, and the spans, gauges and ledgers of the port's serving loop and
ingest pipeline on the CPU.

``Span.finish`` gets fixed event times on both sides and must derive the
same metrics, events and histogram observations. The serving checks hold
the port's server against its own arms (metrics on and off, dense and
paged) and JAX static ``generate``, never against the JAX continuous
server. Every wait is bounded; a fixture restores the switches, the ring
and the recorder and resets both registries around every test.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine import probes as JP
from pathway_tpu.engine import tracing as JT
from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.engine import probes as TP
from pathway_tpu_torch.engine import tracing as TT
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models import embedder as TE
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer, pad_to_buckets
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.torch_parity import configs, np_encoder_params
from tests.utils import ToyCharTokenizer

WAIT = 60

# the TINY decoder of tests/test_observability.py
JCFG = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=128, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=128, dtype=torch.float32)
PROMPTS = [f"req {k:02d} text" for k in range(4)] + [
    "a longer prompt that fills more than one prefill piece", "x"]
MAX_NEW = 6


def _reset_all():
    for p in (TP, JP):
        p.REGISTRY.reset()
        p.reset_hbm_stats()
        p.reset_retrieval_backend_stats()
    TT.reset_traces()
    JT.reset_traces()


@pytest.fixture(autouse=True)
def clean():
    TP.set_metrics(True)
    TT.configure()
    TT.flush_traces()
    _reset_all()
    yield
    TP.set_metrics(True)
    TT.flush_traces()
    TT.configure()
    _reset_all()


# ------------------------------------------------------------ Span.finish

def _fixed_span(mod, names, times, attrs, kind="decode"):
    span = mod.Span(kind, 7, "srv", dict(attrs))
    span.t0 = 100.0
    span.events = [("enqueue", 100.0, None)] + [
        (n, 100.0 + t, {"slot": 1} if n == "admit" else None)
        for n, t in zip(names, times)]
    return span


FINISH_CASES = {
    "decode": (["admit", "prefill_chunk", "decode_chunk", "first_token",
                "decode_chunk", "drain"], dict(tokens=6)),
    "one-token": (["admit", "first_token", "drain"], dict(tokens=1)),
    "no-admit": (["drain"], {}),
    "error": (["admit", "decode_chunk"], dict(error=True, tokens=0)),
    "repeated-events": (["admit", "admit", "first_token", "first_token", "drain",
                         "drain"], dict(tokens=3)),
    "migrate": (["admit", "migrate", "first_token", "drain"], dict(tokens=4)),
}


@pytest.mark.parametrize("case", list(FINISH_CASES))
def test_span_finish_matches_jax(case):
    names, finish_attrs = FINISH_CASES[case]
    times = np.sort(np.random.default_rng(len(case)).uniform(0.0, 3.0, len(names)))
    got = _fixed_span(TT, names, times, {"prompt_tokens": 9}).finish(**finish_attrs)
    want = _fixed_span(JT, names, times, {"prompt_tokens": 9}).finish(**finish_attrs)
    for d in (got, want):
        d.pop("start_unix")
        d.pop("id")
    assert got == want
    assert TP.latency_summary() == JP.latency_summary()
    assert TP.REGISTRY.snapshot() == JP.REGISTRY.snapshot()
    assert len(TT.recent_traces(server="srv")) == 1


def test_finish_is_idempotent_and_null_span_is_inert():
    span = TT.start_span("embed", server="x", texts=3)
    span.event("admit")
    assert span.finish() is not None
    assert span.finish(error=True) is None
    assert TT.recent_traces(server="x", kind="embed")[0]["attrs"] == {"texts": 3}
    TP.set_metrics(False)
    null = TT.start_span("embed", server="x")
    assert null is TT.NULL_SPAN
    null.event("admit")
    assert null.finish() is None
    assert len(TT.recent_traces()) == 1
    TT.reset_traces()  # resets apply with metrics off
    assert TT.recent_traces() == []


def test_trace_ring_is_bounded():
    TT.configure(ring=3)
    for _ in range(7):
        TT.start_span("decode", server="ring").finish()
    spans = TT.recent_traces(server="ring")
    assert len(spans) == 3
    assert [s["id"] for s in spans] == sorted(s["id"] for s in spans)
    assert len(TT.recent_traces(server="ring", n=2)) == 2
    assert TT.recent_traces(server="other") == []


def test_jsonl_flight_recorder_buffers_and_flushes(tmp_path):
    TT.configure(trace_dir=str(tmp_path))
    path = tmp_path / f"trace-{os.getpid()}.jsonl"
    span = TT.start_span("decode", server="jsonl", k=4)
    span.event("admit")
    span.event("drain")
    span.finish()
    assert path.read_text() == ""  # buffered: under the 32-span flush
    TT.flush_traces()
    rec = json.loads(path.read_text().strip().splitlines()[-1])
    assert rec["kind"] == "decode" and rec["server"] == "jsonl" and rec["attrs"]["k"] == 4
    assert [e["name"] for e in rec["events"]] == ["enqueue", "admit", "drain"]
    assert "e2e_ms" in rec["metrics"] and "queue_wait_ms" in rec["metrics"]
    TT.flush_traces()  # idempotent after close
    for _ in range(TT._JSONL_FLUSH_EVERY):
        TT.start_span("decode", server="jsonl").finish()
    # the 32nd buffered span flushed the handle
    assert len(path.read_text().strip().splitlines()) == 1 + TT._JSONL_FLUSH_EVERY
    TT.configure()
    TT.start_span("decode", server="jsonl").finish()
    TT.flush_traces()
    assert len(path.read_text().strip().splitlines()) == 1 + TT._JSONL_FLUSH_EVERY


# -------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def decoder():
    jp = JD.init_params(jax.random.PRNGKey(0), JCFG)
    tok = ToyCharTokenizer(64)
    static = [np.asarray(JD.generate(jp, jnp.asarray([tok.encode(p)], jnp.int32),
                                     jnp.ones((1, len(tok.encode(p))), jnp.int32),
                                     JCFG, MAX_NEW))[0].tolist() for p in PROMPTS]
    return from_jax_params(jax.tree.map(np.asarray, jp)), static


def _chat(params, **kw):
    return DecoderChat(params=params, cfg=TCFG, tokenizer=ToyCharTokenizer(64),
                       max_new_tokens=MAX_NEW, max_prompt_tokens=64, continuous=True,
                       n_slots=2, chunk_steps=4, prefill_chunk=8, device="cpu", **kw)


def _burst(chat, prompts=PROMPTS):
    tok = ToyCharTokenizer(64)
    reqs = [chat.server.submit(tok.encode(p), MAX_NEW) for p in prompts]
    for r in reqs:
        assert r.done.wait(WAIT)
    assert chat.server.failed is None
    return [r.tokens for r in reqs]


def _events(span):
    out = {}
    for e in span["events"]:
        out.setdefault(e["name"], e["t_ms"])
    return out


def _wait_idle_gauges(srv):
    """The occupancy gauge catches up when the loop goes idle."""
    for _ in range(WAIT * 100):
        if srv._occ_published == (srv.stats["chunks"], srv.stats["steps"]):
            return
        time.sleep(0.01)
    raise AssertionError("the serving loop did not go idle")


SERVING_ARMS = {
    "defaults": dict(),
    "spec-off": dict(spec_decode=False),
    "prefix-cache": dict(prefix_cache=True, prefix_cache_mb=4, prefix_block=8),
    "paged": dict(paged_kv=True, paged_kv_block=8, paged_kernel=True, flash_prefill=True),
}


@pytest.mark.parametrize("arm", list(SERVING_ARMS))
def test_serving_spans_complete_and_ordered(decoder, arm):
    params, static = decoder
    shared = arm == "prefix-cache"
    prompts = [f"shared head text {p}" for p in PROMPTS] if shared else PROMPTS
    chat = _chat(params, **SERVING_ARMS[arm])
    try:
        streams = _burst(chat, prompts)
        srv = chat.server
        spans = chat.recent_traces()
        _wait_idle_gauges(srv)
        snap = TP.serving_snapshot()
    finally:
        chat.close()
    if not shared:
        assert streams == static
    assert len(spans) == len(prompts)
    assert {s["server"] for s in spans} == {srv._trace_tag}
    for span in spans:
        ev = _events(span)
        assert ev["enqueue"] == 0.0
        assert 0.0 <= ev["admit"] <= ev["first_token"] <= ev["drain"]
        assert span["attrs"]["tokens"] == MAX_NEW and span["attrs"]["tenant"] == "default"
        assert span["attrs"]["max_new"] == MAX_NEW
        m = span["metrics"]
        assert m["queue_wait_ms"] <= m["ttft_ms"] <= m["e2e_ms"] and "tpot_ms" in m
        names = [e["name"] for e in span["events"]]
        assert names[-1] == "drain" and names.count("first_token") == 1
        assert "spec_cycles" in names or "decode_chunk" in names
        if arm == "spec-off":
            assert "spec_cycles" not in names
        assert ("prefill_chunk" in names) or ("prefill" in names)
        if shared:
            assert "prefix_match" in ev
    if arm == "defaults":  # greedy: the first dispatches are speculative
        assert any(e["name"] == "spec_cycles" for s in spans for e in s["events"])
    lat = TP.latency_summary("decode")
    assert {n: lat[n]["count"] for n in lat} == {n: len(prompts) for n in TP.LATENCY_HISTOGRAMS}
    assert snap["occupancy"] == {srv._trace_tag: round(srv.occupancy(), 4)}
    assert 0.0 < srv.occupancy() <= 1.0
    assert snap["lanes"] == {"prefill": 0.0, "decode": 0.0}
    assert srv.kv_fragmentation()["current"] == 0.0
    if shared:
        assert snap["prefix"]["prefill_tokens_saved"] > 0


def test_metrics_off_streams_equal_and_nothing_recorded(decoder):
    params, static = decoder
    on = _chat(params)
    try:
        on_streams = _burst(on)
    finally:
        on.close()
    assert on_streams == static and len(on.recent_traces()) == len(PROMPTS)
    TP.set_metrics(False)
    _reset_all()
    off = _chat(params)
    try:
        off_streams = _burst(off)
    finally:
        off.close()
    assert off_streams == on_streams
    assert off.recent_traces() == [] and TT.recent_traces() == []
    assert TP.REGISTRY.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert TP.hbm_stats()["current_total_bytes"] == 0


def test_occupancy_fragmentation_and_hbm_dense_and_paged(decoder):
    params, _ = decoder
    frag, servers = {}, {}
    for name, kw in (("dense", dict(spec_decode=False)),
                     ("paged", dict(spec_decode=False, paged_kv=True, paged_kv_block=8))):
        TP.reset_hbm_stats()
        chat = _chat(params, weight_quant="int8", **kw)
        srv = chat.server
        try:
            hbm = TP.hbm_stats()["current_bytes"]
            want_w = sum(t.numel() * t.element_size() for t in TD._tensor_leaves(chat.params))
            assert hbm.pop("weights.decoder") == want_w
            assert sum(hbm.values()) == TD.pool_bytes(srv.pool)
            assert set(hbm) == set(TD.pool_component_device_bytes(srv.pool))
            _burst(chat)
            _wait_idle_gauges(srv)
            assert srv.occupancy() == srv.stats["steps"] / srv.stats["slot_steps_total"]
            assert TP.serving_snapshot()["occupancy"][srv._trace_tag] == round(
                srv.occupancy(), 4)
            frag[name] = srv.kv_fragmentation()
            assert TP.kv_fragmentation_value(srv._trace_tag) == frag[name]["current"] == 0.0
            servers[name] = srv
        finally:
            chat.close()
    # dense slots strand their row tails; paged slots at most a block each
    assert 0.0 < frag["paged"]["mean"] < frag["dense"]["mean"] < 1.0
    assert servers["dense"].stats["steps"] <= servers["dense"].stats["slot_steps_total"]


def test_failed_request_finishes_its_span_with_error(decoder):
    """A paged request that can never fit fails alone: its span finishes
    with error=True and the isolation counter counts it."""
    params, _ = decoder
    chat = _chat(params, spec_decode=False, paged_kv=True, paged_kv_block=8,
                 paged_kv_blocks=4)
    tok = ToyCharTokenizer(64)
    try:
        req = chat.server.submit(tok.encode(PROMPTS[4]), MAX_NEW)
        assert req.done.wait(WAIT) and req.text is None
        assert req.error_reason == "paged_oom"
        spans = chat.recent_traces()
    finally:
        chat.close()
    assert len(spans) == 1 and spans[0]["attrs"]["error"] is True
    # the prefix cache (on by default) matched before the allocation failed
    assert [e["name"] for e in spans[0]["events"]] == ["enqueue", "admit", "prefix_match"]
    assert TP.REGISTRY.labelled("requests_isolated", "outcome") == {"failed": 1.0}


def test_flight_recorder_flushed_at_shutdown(decoder, tmp_path):
    params, _ = decoder
    TT.configure(trace_dir=str(tmp_path))
    chat = _chat(params)
    try:
        _burst(chat, PROMPTS[:3])
        path = tmp_path / f"trace-{os.getpid()}.jsonl"
        assert not path.exists() or path.read_text() == ""  # still buffered
    finally:
        chat.close()
    recs = [json.loads(line) for line in path.read_text().strip().splitlines()]
    assert len(recs) == 3 and {r["kind"] for r in recs} == {"decode"}
    assert all(r["server"] == chat.server._trace_tag for r in recs)


# --------------------------------------------------------------- ingest

def _embedder(**kw):
    _, tcfg = configs("float32")
    return TE.SentenceEmbedderModel(tcfg, params=from_jax_params(np_encoder_params(40)),
                                    tokenizer=HashTokenizer(vocab_size=1000),
                                    max_length=32, device="cpu", **kw)


BATCHES = [["alpha beta", "gamma"], ["delta epsilon zeta eta theta iota"] * 3,
           ["kappa"]]


def test_ingest_spans_dispatches_and_attention():
    m = _embedder()
    try:
        TP.REGISTRY.reset()
        out = m.embed_resolve([m.embed_submit(b) for b in BATCHES], WAIT)
        spans = m.recent_traces()
    finally:
        m.close()
    assert len(spans) == len(BATCHES)
    for span, batch in zip(spans, BATCHES):
        assert [e["name"] for e in span["events"]] == [
            "enqueue", "admit", "tokenize", "h2d", "dispatch", "drain"]
        assert span["attrs"] == {"texts": len(batch)}
        assert span["events"][4]["rows"] == len(batch)
        t = [e["t_ms"] for e in span["events"]]
        assert t == sorted(t)
    assert TP.dispatch_counts() == {"embed_dispatch": len(BATCHES), "embed_drain": 1}
    assert TP.latency_summary("embed")["e2e_seconds"]["count"] == len(BATCHES)
    want = 0
    for b in BATCHES:
        ids, _ = pad_to_buckets(*m.tokenizer(b, max_length=32))
        B, S = ids.shape
        want += m.cfg.layers * TE.FA.attn_bytes_flash(S, S, m.cfg.heads, m.cfg.head_dim,
                                                      batch=B)
    assert TP.attn_stats()["bytes"] == {"encoder": want}
    assert TP.stage_items()["drain"] == 1
    assert [o.shape[0] for o in out] == [len(b) for b in BATCHES]


def test_ingest_metrics_off_is_byte_identical_and_silent():
    on = _embedder()
    try:
        want = on.embed_resolve([on.embed_submit(b) for b in BATCHES], WAIT)
    finally:
        on.close()
    TP.set_metrics(False)
    _reset_all()
    for kw in (dict(), dict(pipeline=False)):
        off = _embedder(**kw)
        try:
            got = off.embed_resolve([off.embed_submit(b) for b in BATCHES], WAIT)
            got_serial = off.embed_batch(BATCHES[1])
        finally:
            off.close()
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert np.array_equal(got_serial, want[1])
        assert off.recent_traces() == []
    assert TP.REGISTRY.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_serial_ingest_counts_dispatches_without_spans():
    m = _embedder(pipeline=False)
    TP.REGISTRY.reset()
    m.embed_resolve([m.embed_submit(b) for b in BATCHES])
    m.embed_device(BATCHES[0])
    assert TP.dispatch_counts() == {"embed_dispatch": len(BATCHES) + 1, "embed_drain": 1}
    assert m.recent_traces() == []


def test_ingest_stage_failure_finishes_its_span_with_error():
    class Failing(HashTokenizer):
        def __call__(self, texts, **kw):
            if "boom" in texts:
                raise RuntimeError("tokenize failed")
            return super().__call__(texts, **kw)

    m = _embedder()
    m.tokenizer = Failing(vocab_size=1000)
    try:
        ok = m.embed_submit(["fine"])
        bad = m.embed_submit(["boom"])
        with pytest.raises(RuntimeError, match="tokenize failed"):
            m.embed_resolve([ok, bad], WAIT)
        assert len(m.embed_resolve([ok], WAIT)[0]) == 1
        spans = m.recent_traces()
    finally:
        m.close()
    failed = [s for s in spans if s["attrs"].get("error")]
    assert len(failed) == 1
    assert [e["name"] for e in failed[0]["events"]] == ["enqueue", "admit"]
    done = [s for s in spans if not s["attrs"].get("error")]
    assert len(done) == 1 and done[0]["events"][-1]["name"] == "drain"
