"""The port's metrics registry, ledgers, OpenMetrics text and byte
accounting against the JAX package (``pathway_tpu/engine/probes.py``,
``internals/http_server.py``, ``models/decoder.py``).

Every comparison runs the same calls, with inputs drawn from one numpy
seed, through the JAX module and the port's, and asks for equal results:
the arithmetic is the same on both sides (bucket interpolation, rounding),
so equality is exact. The JAX kill switch is its environment flag, set
with ``monkeypatch``; the port's is ``probes.set_metrics``. A fixture
restores the switches and resets both registries around every test.
"""

import re
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine import probes as JP
from pathway_tpu.internals import http_server as JH
from pathway_tpu.models import decoder as JD
from pathway_tpu.models import embedder as JE
from pathway_tpu.models import cross_encoder as JX
from pathway_tpu.xpacks.llm import llms as JL
from pathway_tpu_torch.engine import probes as TP
from pathway_tpu_torch.engine import tracing as TT
from pathway_tpu_torch.internals import http_server as TH
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models import embedder as TE
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.xpacks.llm import llms as TL
from tests.torch_parity import configs, np_encoder_params, np_head, to_jax


def _reset_all(p):
    p.REGISTRY.reset()
    p.reset_hbm_stats()
    p.reset_retrieval_backend_stats()


@pytest.fixture(autouse=True)
def clean():
    TP.set_metrics(True)
    for p in (TP, JP):
        _reset_all(p)
    TT.reset_traces()
    yield
    TP.set_metrics(True)
    TT.configure()
    for p in (TP, JP):
        _reset_all(p)
    TT.reset_traces()


def _ops(seed: int, n: int = 400):
    """A seeded sequence of registry writes: (method, args, labels)."""
    rng = np.random.default_rng(seed)
    names = ["reqs", "bytes_moved", "lat", "occ", "hw"]
    ops = []
    for _ in range(n):
        labels = {"kind": str(rng.choice(["a", "b", 'q"uote\\n'])),
                  "server": str(rng.choice(["s1", "s2"]))}
        if rng.random() < 0.3:
            labels = {"kind": labels["kind"]}
        which = rng.integers(6)
        if which == 0:
            ops.append(("counter_add", (names[0], float(rng.integers(1, 9))), labels))
        elif which == 1:
            ops.append(("gauge_set", (names[3], float(rng.random())), labels))
        elif which == 2:
            ops.append(("gauge_add", (names[3], float(rng.normal())), labels))
        elif which == 3:
            # log-uniform over the bucket range and beyond it on both ends
            v = float(10.0 ** rng.uniform(-5.0, 2.5))
            ops.append(("observe", (names[2], v), labels))
        elif which == 4:
            ops.append(("gauge_max", (names[4], float(rng.integers(0, 1000))), labels))
        else:
            counts = {str(k): float(rng.integers(1, 5)) for k in rng.choice(
                ["x", "y", "z"], size=2, replace=False)}
            ops.append(("counter_add_many", (names[1], "kind", counts), {}))
    return ops


def _apply(reg, ops):
    for method, args, labels in ops:
        getattr(reg, method)(*args, **labels)


def test_registry_snapshot_and_summaries_match_jax():
    ops = _ops(seed=0)
    j, t = JP.MetricsRegistry(), TP.MetricsRegistry()
    _apply(j, ops)
    _apply(t, ops)
    assert t.snapshot() == j.snapshot()
    assert t.hist_bounds == j.hist_bounds and len(t.hist_bounds) == 21
    for labels in ({}, {"kind": "a"}, {"kind": "b", "server": "s2"}, {"server": "none"}):
        got, want = t.hist_summary("lat", **labels), j.hist_summary("lat", **labels)
        assert got == want
    assert t.hist_summary("lat")["count"] > 50
    for name, label, kind in (("reqs", "kind", "counter"), ("reqs", "server", "counter"),
                              ("bytes_moved", "kind", "counter"), ("occ", "kind", "gauge"),
                              ("hw", "server", "gauge")):
        assert t.labelled(name, label, kind=kind) == j.labelled(name, label, kind=kind)
    for labels in ({}, {"kind": "a"}, {"kind": "a", "server": "s1"}):
        assert t.gauge_value("occ", **labels) == j.gauge_value("occ", **labels)
    assert t.gauge_value("missing") is None
    t.remove("reqs", "lat")
    j.remove("reqs", "lat")
    assert t.snapshot() == j.snapshot() and "reqs" not in t.snapshot()["counters"]


def test_eight_writer_threads_lose_no_increment():
    reg = TP.MetricsRegistry()
    threads_n, per = 8, 2000
    barrier = threading.Barrier(threads_n)

    def hammer():
        barrier.wait(timeout=30)
        for i in range(per):
            reg.counter_add("hammer", 1, kind="x")
            reg.gauge_add("hammer_gauge", 1.0)
            reg.observe("hammer_lat", 1e-3 * ((i % 10) + 1))
            reg.counter_add_many("many", "kind", {"a": 1, "b": 2})

    workers = [threading.Thread(target=hammer) for _ in range(threads_n)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    total = threads_n * per
    assert reg.labelled("hammer", "kind") == {"x": float(total)}
    assert reg.gauge_value("hammer_gauge") == float(total)
    assert reg.hist_summary("hammer_lat")["count"] == total
    assert reg.labelled("many", "kind") == {"a": float(total), "b": 2.0 * total}


def test_kill_switch_stops_writes_not_resets(monkeypatch):
    ops = _ops(seed=1, n=60)
    monkeypatch.setenv("PATHWAY_TPU_METRICS", "0")
    TP.set_metrics(False)
    j, t = JP.MetricsRegistry(), TP.MetricsRegistry()
    assert not j.enabled and not t.enabled and not TP.metrics_enabled()
    _apply(j, ops)
    _apply(t, ops)
    empty = {"counters": {}, "gauges": {}, "histograms": {}}
    assert t.snapshot() == j.snapshot() == empty
    for p in (TP, JP):
        p.record_prefix("requests", 3)
        p.record_device_dispatch("knn_search")
        p.record_hbm("weights.decoder", 100)
        p.record_attn("prefill", 10.0, saved=5.0)
        p.observe_latency("ttft_seconds", 0.1, "decode")
    assert TP.REGISTRY.snapshot() == JP.REGISTRY.snapshot() == empty
    assert TP.hbm_stats() == JP.hbm_stats()
    assert TP.hbm_stats()["current_total_bytes"] == 0
    assert TT.start_span("decode") is TT.NULL_SPAN
    monkeypatch.setenv("PATHWAY_TPU_METRICS", "1")
    TP.set_metrics(True)
    _apply(j, ops)
    _apply(t, ops)
    assert t.snapshot() == j.snapshot() != empty
    TP.set_metrics(False)
    t.reset()  # resets apply with metrics off
    assert t.snapshot() == empty


# ---------------------------------------------------------------- ledgers

def _prefix(p, rng):
    for kind in rng.choice(["requests", "hit_requests", "hit_tokens", "miss_tokens",
                            "t2_lookups", "t2_hits", "copy_bytes", "evicted_blocks",
                            "cached_bytes", "t2_demoted_blocks"], 30):
        p.record_prefix(str(kind), int(rng.integers(-3, 40)) if kind == "cached_bytes"
                        else int(rng.integers(1, 40)))
    return p.prefix_stats()


def _spec(p, rng):
    for _ in range(10):
        p.record_spec("drafted", int(rng.integers(1, 30)))
        p.record_spec_many(accepted=int(rng.integers(0, 10)), emitted=int(rng.integers(1, 30)),
                           verify_steps=int(rng.integers(1, 9)), dispatches=1)
    p.record_spec("kv_bytes_saved", 4096)
    return p.spec_stats()


def _cascade(p, rng):
    for stage in ("cheap", "maxsim", "full", "full"):
        p.record_cascade(stage, int(rng.integers(1, 100)), float(rng.integers(0, 3)) * 1.7e9)
    return p.cascade_stats()


def _attn(p, rng):
    for path in rng.choice(["prefill", "chunk", "encoder"], 12):
        p.record_attn(str(path), float(rng.integers(1, 10**6)),
                      saved=float(rng.integers(0, 2)) * float(rng.integers(1, 10**5)))
    return p.attn_stats()


def _dispatch(p, rng):
    for kind in rng.choice(["embed_dispatch", "embed_drain", "knn_search", "knn_append"], 20):
        p.record_device_dispatch(str(kind), int(rng.integers(1, 3)))
    return p.dispatch_counts()


def _retrieval(p, rng):
    for _ in range(5):
        p.record_retrieval_backend("dense", int(rng.integers(1, 9)))
    return p.retrieval_backend_stats()


def _stage(p, rng):
    for stage in rng.choice(["tokenize", "h2d", "dispatch", "drain"], 16):
        p.record_stage(str(stage), float(rng.random()), int(rng.integers(1, 4)))
    return p.stage_seconds(), p.REGISTRY.labelled("stage_items", "stage")


def _bubble(p, rng):
    _stage(p, rng)
    return (p.bubble_attribution(float(rng.uniform(1.0, 20.0))),
            p.bubble_attribution(0.5, {"tokenize": 0.25, "drain": 0.5}))


def _latency(p, rng):
    for _ in range(40):
        name = str(rng.choice(p.LATENCY_HISTOGRAMS))
        p.observe_latency(name, float(10.0 ** rng.uniform(-4, 1)),
                          str(rng.choice(["decode", "embed"])))
    return p.latency_summary(), p.latency_summary("decode"), p.latency_summary("query")


def _hbm(p, rng):
    for _ in range(12):
        p.record_hbm(str(rng.choice(["slot_pool", "kv_scales", "weights.decoder"])),
                     int(rng.integers(0, 10**9)), device=str(rng.choice(["0", "1"])))
    p.record_hbm("prefix_arena", 5)  # the single-device default label
    return p.hbm_stats(), p.REGISTRY.snapshot()["gauges"]


def _serving(p, rng):
    _prefix(p, rng)
    _spec(p, rng)
    _attn(p, rng)
    _dispatch(p, rng)
    _retrieval(p, rng)
    _stage(p, rng)
    _latency(p, rng)
    p.REGISTRY.gauge_set("serving_occupancy", 0.123456, server="decode:1")
    p.REGISTRY.gauge_set("lane_occupancy", 3.0, server="decode:1", lane="decode")
    p.record_kv_fragmentation(0.25, server="decode:1")
    return p.serving_snapshot(), p.kv_fragmentation_value("decode:1")


LEDGERS = {f.__name__[1:]: f for f in (_prefix, _spec, _cascade, _attn, _dispatch,
                                       _retrieval, _stage, _bubble, _latency, _hbm,
                                       _serving)}


@pytest.mark.parametrize("ledger", list(LEDGERS))
def test_ledger_matches_jax(ledger):
    got = LEDGERS[ledger](TP, np.random.default_rng(7))
    want = LEDGERS[ledger](JP, np.random.default_rng(7))
    assert got == want
    assert got  # the ledger recorded something


def test_reset_functions_match_jax():
    for p in (TP, JP):
        _serving(p, np.random.default_rng(3))
        _hbm(p, np.random.default_rng(3))
        for fn in ("reset_prefix_stats", "reset_spec_stats", "reset_cascade_stats",
                   "reset_attn_stats", "reset_dispatch_counts", "reset_stage_seconds",
                   "reset_latency_metrics", "reset_hbm_stats",
                   "reset_retrieval_backend_stats"):
            getattr(p, fn)()
    assert TP.serving_snapshot() == JP.serving_snapshot()
    assert TP.REGISTRY.snapshot() == JP.REGISTRY.snapshot()
    assert set(TP.REGISTRY.snapshot()["gauges"]) == {"serving_occupancy", "lane_occupancy",
                                                     "kv_fragmentation"}


def test_unified_snapshot_and_roofline():
    _serving(TP, np.random.default_rng(5))
    TP.record_hbm("weights.decoder", 1000)
    uni = TP.unified_snapshot()
    assert set(uni) == {"scheduler", "serving", "hbm", "slo", "registry"}
    assert uni["scheduler"] is None
    assert uni["serving"] == TP.serving_snapshot()
    assert uni["hbm"]["current_bytes"] == {"weights.decoder": 1000}
    assert uni["registry"] == TP.REGISTRY.snapshot()
    assert TP.unified_snapshot({"epochs": 3})["scheduler"] == {"epochs": 3}
    # the same arithmetic as JAX given the same peaks; the H100's by default
    peaks = dict(peak_flops=TP.H100_PEAK_BF16_FLOPS, peak_bytes=TP.H100_PEAK_HBM_BYTES)
    for flops, nbytes, wall in ((4e12, 1e9, 0.02), (1e9, 8e9, None), (0.0, 0.0, 1e-3)):
        got = TP.roofline_ceiling(flops, nbytes, wall_s=wall)
        assert got == JP.roofline_ceiling(flops, nbytes, wall_s=wall, **peaks)
    assert TP.roofline_ceiling(4e12, 1e9)["ridge_intensity"] == round(989.4e12 / 3.35e12, 2)
    tm, jm = TP.RooflineModel(), JP.RooflineModel(**peaks)
    for m in (tm, jm):
        m.add("ingest", seconds=0.5, flops=3e13, bytes_moved=2e11, dispatches=8)
        m.add("query", seconds=0.01, flops=1e9, bytes_moved=1e6, dispatches=1)
        m.add("ingest", seconds=0.25, flops=1e13)
    assert tm.summary() == jm.summary()
    assert TP.PhaseRoofline("x", 1.0, 1e12, 1e9).summary() == \
        JP.PhaseRoofline("x", 1.0, 1e12, 1e9).summary(**peaks)


# ----------------------------------------------------------- OpenMetrics

# one sample line (name, optional {labels}, a number) and the comment
# lines: the OpenMetrics regexes of tests/test_observability.py
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' (-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$'
)
_COMMENT_RE = re.compile(
    r"^# (HELP [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)"
    r"|EOF)$"
)


def _families_before_samples(text: str) -> None:
    """Every line parses, and each sample's family had its HELP and TYPE
    lines before it."""
    lines = text.rstrip("\n").split("\n")
    assert lines[-1] == "# EOF"
    seen: dict[str, set] = {}
    for line in lines:
        if line.startswith("#"):
            assert _COMMENT_RE.match(line), line
            if line != "# EOF":
                _, what, name = line.split(" ", 3)[:3]
                seen.setdefault(name, set()).add(what)
            continue
        assert _SAMPLE_RE.match(line), line
        name = re.match(r"[a-zA-Z0-9_:]+", line).group(0)
        fam = re.sub(r"(_total|_bucket|_sum|_count)$", "", name)
        assert seen.get(fam) == {"HELP", "TYPE"}, line


def test_registry_text_matches_jax():
    ops = _ops(seed=2)
    j, t = JP.MetricsRegistry(), TP.MetricsRegistry()
    _apply(j, ops)
    _apply(t, ops)
    for p in (TP, JP):
        _serving(p, np.random.default_rng(9))
        _hbm(p, np.random.default_rng(9))
    for snap in (t.snapshot(), TP.REGISTRY.snapshot(), {"counters": {}, "gauges": {},
                                                        "histograms": {}}):
        assert TH.registry_text(snap) == JH.registry_text(snap)
    assert TP.METRIC_FAMILIES == JP.METRIC_FAMILIES
    assert TP.LATENCY_HISTOGRAMS == JP.LATENCY_HISTOGRAMS
    assert TH.registry_text() == JH.registry_text(JP.REGISTRY.snapshot())
    text = TH.openmetrics_text()
    assert text == TH.registry_text() + "# EOF\n"
    _families_before_samples(text)
    _families_before_samples(TH.openmetrics_text(t.snapshot()))
    assert '\\"uote\\\\n' in TH.registry_text(t.snapshot())  # escaped label
    # an early scrape shows every declared family
    TP.REGISTRY.reset()
    empty = TH.openmetrics_text()
    _families_before_samples(empty)
    for fam in TP.METRIC_FAMILIES:
        assert f"# TYPE pathway_tpu_{fam} " in empty


# ------------------------------------------------------------------ bytes

JCFG = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=128, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=128, dtype=torch.float32)


@pytest.fixture(scope="module")
def decoder_params():
    jp = JD.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


POOLS = {
    "dense": dict(),
    "dense-int8kv": dict(kv_quant=True),
    "arena": dict(arena_blocks=3, arena_block=8),
    "arena-int8kv": dict(arena_blocks=3, arena_block=8, kv_quant=True),
    "paged": dict(paged=True),
    "paged-int8kv": dict(paged=True, kv_quant=True),
}


@pytest.mark.parametrize("int8_weights", [False, True])
def test_params_device_bytes_match_jax(decoder_params, int8_weights):
    jp, tp = decoder_params
    if int8_weights:
        jp, tp = JD.quantize_params(jp, JCFG), TD.quantize_params(tp, TCFG)
    got = TD.params_device_bytes(tp)
    assert got == JD.params_device_bytes(jp)
    leaves = [t for layer in (tp,) for t in TD._tensor_leaves(layer)]
    assert got == {"0": sum(t.numel() * t.element_size() for t in leaves)}


@pytest.mark.parametrize("pool", list(POOLS))
def test_pool_component_bytes_match_jax(decoder_params, pool):
    jp, tp = decoder_params
    kw = dict(POOLS[pool])
    if kw.pop("paged", False):
        jpool = JD.paged_pool_init(jp, JCFG, 3, 32, n_blocks=9, block=8, **kw)
        tpool = TD.paged_pool_init(tp, TCFG, 3, 32, n_blocks=9, block=8, **kw)
    else:
        jpool = JD.pool_init(jp, JCFG, 3, 32, **kw)
        tpool = TD.pool_init(tp, TCFG, 3, 32, **kw)
    got = TD.pool_component_device_bytes(tpool)
    assert got == JD.pool_component_device_bytes(jpool)
    assert TD.pool_bytes(tpool) == JD.pool_bytes(jpool)
    assert TD.pool_bytes(tpool) == sum(v["0"] for v in got.values())
    assert set(TD._HBM_COMPONENT_KEYS) == set(JD._HBM_COMPONENT_KEYS)


# ------------------------------------------------- attention and dispatch

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_serving_attention_bytes_match_jax(dtype, flash, kv_quant):
    jcfg = JD.DecoderConfig(vocab_size=128, hidden=48, layers=3, heads=6,
                            intermediate=64, max_position=512, dtype=getattr(jnp, dtype))
    tcfg = TD.DecoderConfig(vocab_size=128, hidden=48, layers=3, heads=6,
                            intermediate=64, max_position=512, dtype=getattr(torch, dtype))
    calls = [("prefill", 64, 64, 1, False), ("prefill", 128, 128, 4, False),
             ("chunk", 16, 208, 1, True), ("chunk", 64, 704, 1, True)]
    for cls, cfg, p in ((TL._ContinuousServer, tcfg, TP), (JL._ContinuousServer, jcfg, JP)):
        stub = types.SimpleNamespace(cfg=cfg, flash_prefill=flash, kv_quant=kv_quant)
        for path, n_q, n_k, batch, cached in calls:
            cls._record_attn(stub, path, n_q, n_k, batch=batch, cached_kv=cached)
    assert TP.attn_stats() == JP.attn_stats()
    assert TP.attn_stats()["total_saved"] > 0 if flash else TP.attn_stats()["bytes_saved"] == {}


@pytest.mark.parametrize("flash", [False, True])
def test_encoder_attention_bytes_match_jax(flash):
    jcfg, tcfg = configs("float32")
    for batch, seq in ((1, 16), (64, 32), (4096, 16)):
        TE._record_encoder_attn(tcfg, batch, seq, flash)
        JE._record_encoder_attn(jcfg, batch, seq, flash)
        TE._record_encoder_attn(tcfg, batch, seq, flash)  # the cross-encoder's
        JX._record_rerank_attn(jcfg, batch, seq, flash)
    assert TP.attn_stats() == JP.attn_stats()
    assert set(TP.attn_stats()["bytes"]) == {"encoder"}


def test_cross_encoder_scoring_charges_its_attention_bytes():
    """Each scoring dispatch charges the accounting model at its padded
    shape: the port with the flash arm it runs, JAX with its default dense
    arm (``PATHWAY_TPU_FLASH_PREFILL`` off)."""
    from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
    from pathway_tpu.models.tokenizer import HashTokenizer as JTok
    from pathway_tpu_torch import CrossEncoderModel, HashTokenizer

    jcfg, tcfg = configs("float32")
    r_np, head = np_encoder_params(33), np_head(34)
    pairs = [("what is alpha", "alpha is a letter"), ("beta", "a longer beta doc " * 3)]
    tce = CrossEncoderModel(tcfg, params=from_jax_params(r_np), head=from_jax_params(head),
                            tokenizer=HashTokenizer(vocab_size=1000), device="cpu")
    jce = JCross(jcfg, params=to_jax(r_np), head=to_jax(head),
                 tokenizer=JTok(vocab_size=1000))
    TP.REGISTRY.reset()
    JP.REGISTRY.reset()
    np.testing.assert_allclose(tce.score_batch(pairs), np.asarray(jce.score_batch(pairs)),
                               rtol=1e-4, atol=1e-4)
    from pathway_tpu_torch.models.tokenizer import pad_to_buckets

    ids = pad_to_buckets(*tce.tokenizer.encode_pairs(pairs, max_length=256,
                                                     return_types=True))[0]
    B, S = ids.shape
    L, H, hd = tcfg.layers, tcfg.heads, tcfg.head_dim
    flash = L * TE.FA.attn_bytes_flash(S, S, H, hd, batch=B)
    dense = L * TE.FA.attn_bytes_dense(S, S, H, batch=B)
    assert TP.attn_stats()["bytes"] == {"encoder": flash}
    assert TP.attn_stats()["bytes_saved"] == {"encoder": dense - flash}
    assert JP.attn_stats()["bytes"] == {"encoder": dense}


def test_rag_dispatch_counts_match_jax():
    """Dispatch counts, the retrieval-backend ledger and the index's append
    stage after the same ``FusedRAGPipeline`` and index calls."""
    from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
    from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
    from pathway_tpu.models.tokenizer import HashTokenizer as JTok
    from pathway_tpu.ops.fused_query import FusedRAGPipeline as JPipe
    from pathway_tpu.ops.knn import BruteForceKnnIndex as JIndex
    from pathway_tpu_torch import (
        BruteForceKnnIndex,
        CrossEncoderModel,
        FusedRAGPipeline,
        HashTokenizer,
        SentenceEmbedderModel,
    )

    jcfg, tcfg = configs("float32")
    e_np, r_np, head = np_encoder_params(30), np_encoder_params(31), np_head(32)
    rng = np.random.default_rng(4)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
    docs = [" ".join(rng.choice(words, 6)) for _ in range(20)]
    kw = dict(reserved_space=64, doc_seq=16, pair_seq=48)
    jtok = JTok(vocab_size=1000)
    jemb = JEmbed(jcfg, params=to_jax(e_np), tokenizer=jtok, max_length=32)
    jp = JPipe(jemb, JCross(jcfg, params=to_jax(r_np), head=to_jax(head),
                            tokenizer=jtok), **kw)
    ttok = HashTokenizer(vocab_size=1000)
    temb = SentenceEmbedderModel(tcfg, params=from_jax_params(e_np), tokenizer=ttok,
                                 max_length=32, device="cpu")
    tp = FusedRAGPipeline(temb, CrossEncoderModel(tcfg, params=from_jax_params(r_np),
                                                  head=from_jax_params(head),
                                                  tokenizer=ttok, device="cpu"), **kw)
    assert TP.hbm_stats()["current_bytes"] == JP.hbm_stats()["current_bytes"]
    assert set(TP.hbm_stats()["current_bytes"]) == {"weights.embedder", "weights.reranker"}
    keys = [f"d{i}" for i in range(len(docs))]
    vecs = rng.standard_normal((6, 32)).astype(np.float32)
    ji, ti = JIndex(32, reserved_space=64), BruteForceKnnIndex(32, reserved_space=64,
                                                              device="cpu")
    try:
        for p in (TP, JP):
            p.REGISTRY.reset()
            p.reset_retrieval_backend_stats()
        for pipe, index, dev in ((jp, ji, jnp.asarray), (tp, ti, torch.from_numpy)):
            pipe.add(keys[:12], docs[:12])
            pipe.add(keys[12:], docs[12:])
            pipe.retrieve(docs[:3], k=4)
            pipe.retrieve_rerank(docs[5], k=4)
            pipe.retrieve_rerank_batch(docs[6:9], k=4)
            index.add(["v0", "v1", "v2"], vecs[:3])
            index.add_device(["v3", "v4"], dev(vecs[3:5]))
            index.search(vecs[:2], 3)
        want = JP.dispatch_counts()
        assert TP.dispatch_counts() == want == {
            "knn_embed_append": 2, "fused_retrieve": 1, "fused_retrieve_rerank": 2,
            "knn_append": 2, "knn_search": 1, "knn_drain": 1}
        assert TP.retrieval_backend_stats() == JP.retrieval_backend_stats() == {"dense": 3}
        assert (TP.REGISTRY.labelled("stage_items", "stage")
                == JP.REGISTRY.labelled("stage_items", "stage") == {"append": 4.0})
    finally:
        jemb.close()
        temb.close()


# ------------------------------------------------ the HBM ledger's owners

def _hbm_owned(p, rng, owners):
    for _ in range(16):
        p.record_hbm(str(rng.choice(["kv_blocks", "weights.decoder", "late_bank"])),
                     int(rng.integers(0, 10**6)), device=str(rng.choice(["0", "1"])),
                     **({"owner": str(rng.choice(owners))} if owners else {}))


def test_hbm_ledger_sums_over_owners_and_drops_an_owner():
    """Entries keyed (component, device, owner): the ledger and its gauges
    are sums over owners; one owner (the default "") reads as JAX's
    (component, device) ledger; a dropped owner's bytes leave the current
    sums and the gauges, the high-waters stay."""
    _hbm_owned(TP, np.random.default_rng(5), None)
    _hbm_owned(JP, np.random.default_rng(5), None)
    assert TP.hbm_stats() == JP.hbm_stats()
    assert TP.REGISTRY.snapshot() == JP.REGISTRY.snapshot()
    for p in (TP, JP):
        _reset_all(p)
    TP.record_hbm("kv_blocks", 100, owner="a")
    TP.record_hbm("kv_blocks", 40, owner="b")
    TP.record_hbm("kv_blocks", 7, device="1", owner="b")
    TP.record_hbm("weights.decoder", 10, owner="a")
    st = TP.hbm_stats()
    assert st["current_bytes"] == {"kv_blocks": 147, "weights.decoder": 10}
    assert st["device_bytes"] == {"0": {"kv_blocks": 140, "weights.decoder": 10},
                                  "1": {"kv_blocks": 7}}
    assert TP.REGISTRY.gauge_value("hbm_bytes", component="kv_blocks", device="0") == 140
    assert TP.REGISTRY.gauge_value("hbm_bytes", component="kv_blocks") == 147
    TP.record_hbm("kv_blocks", 60, owner="a")  # an owner re-records its own entry
    assert TP.hbm_stats()["current_bytes"]["kv_blocks"] == 107
    TP.drop_hbm_owner("a")
    st = TP.hbm_stats()
    assert st["current_bytes"] == {"kv_blocks": 47}
    assert st["high_water_bytes"] == {"kv_blocks": 147, "weights.decoder": 10}
    assert st["high_water_total_bytes"] == 157
    assert TP.REGISTRY.gauge_value("hbm_bytes", component="kv_blocks", device="0") == 40
    assert TP.REGISTRY.gauge_value("hbm_bytes", component="weights.decoder") == 0
    TP.drop_hbm_owner("nobody")
    TP.set_metrics(False)
    TP.drop_hbm_owner("b")  # applies with metrics off, like the resets
    TP.set_metrics(True)
    assert TP.hbm_stats()["current_total_bytes"] == 0


def test_hbm_owner_is_dropped_when_its_holder_is_collected():
    """A holder let go without ``close()``: its entries leave at the next
    ledger call after its collection, before anything else, so a new
    holder recording under the same tag keeps its entry."""
    import gc

    class Holder:
        pass

    h = Holder()
    TP.drop_hbm_owner_at_collect(h, "h")
    TP.record_hbm("late_bank", 30, owner="h")
    TP.record_hbm("late_bank", 5, device="1", owner="h")
    TP.record_hbm("weights.embedder", 7, owner="k")
    assert TP.hbm_owner_bytes("h") == {"late_bank": 35}
    del h
    gc.collect()
    TP.record_hbm("late_bank", 9, owner="h")  # a new holder under the same tag
    assert TP.hbm_owner_bytes("h") == {"late_bank": 9}
    assert TP.hbm_stats()["current_bytes"] == {"late_bank": 9, "weights.embedder": 7}
    assert TP.REGISTRY.gauge_value("hbm_bytes", component="late_bank", device="1") == 0


def test_collected_encoders_and_pipeline_leave_the_ledger():
    import gc

    from pathway_tpu_torch import (CrossEncoderModel, FusedRAGPipeline, HashTokenizer,
                                   SentenceEmbedderModel)

    _, tcfg = configs("float32")
    tok = HashTokenizer(vocab_size=1000)
    emb = SentenceEmbedderModel(tcfg, params=from_jax_params(np_encoder_params(40)),
                                tokenizer=tok, max_length=32, device="cpu", pipeline=False)
    ce = CrossEncoderModel(tcfg, params=from_jax_params(np_encoder_params(41)),
                           tokenizer=tok, device="cpu")
    pipe = FusedRAGPipeline(emb, ce, reserved_space=32, doc_seq=16, pair_seq=48,
                            late_interaction=True, rerank_cascade=True)
    pipe.add(["a", "b"], ["alpha beta", "gamma"])
    owners = [emb.hbm_owner, ce.hbm_owner, pipe.hbm_owner]
    assert [set(TP.hbm_owner_bytes(o)) for o in owners] == [
        {"weights.embedder"}, {"weights.reranker"}, {"late_bank"}]
    del emb, ce, pipe
    gc.collect()
    assert [TP.hbm_owner_bytes(o) for o in owners] == [{}, {}, {}]
    assert TP.hbm_stats()["current_bytes"] == {}


def _ledger_chat(params, **kw):
    return TL.DecoderChat(params=params, cfg=TCFG, tokenizer=_TOK, max_new_tokens=8,
                          max_prompt_tokens=48, continuous=True, n_slots=2, chunk_steps=4,
                          pipeline_depth=2, prefill_chunk=8, device="cpu", **kw)


_TOK = types.SimpleNamespace(encode=lambda s: [ord(c) % 96 + 1 for c in s][:48],
                             decode=lambda ids: "".join(chr(int(i) % 96 + 32) for i in ids),
                             eos_id=None)


@pytest.mark.parametrize("kw", [dict(), dict(paged_kv=True, paged_kv_block=8),
                                dict(weight_quant="int8", kv_quant=True)])
def test_one_servers_hbm_stats_are_jaxs_ledger(decoder_params, kw, monkeypatch):
    """A single server's ledger is unchanged by the owner keys: replaying
    its records into JAX's (component, device) ledger gives the same
    ``hbm_stats()`` and gauges, before and after a burst."""
    _, tparams = decoder_params
    real = TP.record_hbm

    def both(component, nbytes, device="0", owner=""):
        real(component, nbytes, device=device, owner=owner)
        JP.record_hbm(component, nbytes, device=device)

    monkeypatch.setattr(TP, "record_hbm", both)
    chat = _ledger_chat(tparams, **kw)
    try:
        assert TP.hbm_stats() == JP.hbm_stats()
        want = TD.pool_component_device_bytes(chat.server.pool)
        got = TP.hbm_stats()["device_bytes"]["0"]
        assert {c: v for c, v in got.items() if c != "weights.decoder"} == {
            c: d["0"] for c, d in want.items()}
        reqs = chat.submit_batch(["hello world", "abc"])
        for r in reqs:
            assert r.done.wait(60.0)
        assert TP.hbm_stats() == JP.hbm_stats()
        assert TP.REGISTRY.labelled("hbm_bytes", "component") == JP.REGISTRY.labelled(
            "hbm_bytes", "component")
    finally:
        chat.close()
    assert TP.hbm_stats()["current_total_bytes"] == 0


def test_two_replicas_hold_twice_one_servers_bytes(decoder_params):
    """Two in-process replicas on one device: the ledger holds both pools
    and both weights (before the owner keys it held one), and nothing
    after both stop."""
    from pathway_tpu_torch.serving import InProcessReplica

    _, tparams = decoder_params
    one = _ledger_chat(tparams, paged_kv=True, paged_kv_block=8)
    single = dict(TP.hbm_stats()["current_bytes"])
    pool = TD.pool_component_device_bytes(one.server.pool)
    weights = TD.params_device_bytes(one.params)["0"]
    one.close()
    assert TP.hbm_stats()["current_total_bytes"] == 0
    assert single == {**{c: d["0"] for c, d in pool.items()}, "weights.decoder": weights}
    reps = [InProcessReplica(f"r{i}", _ledger_chat(tparams, paged_kv=True, paged_kv_block=8))
            for i in range(2)]
    try:
        st = TP.hbm_stats()
        assert st["current_bytes"] == {c: 2 * v for c, v in single.items()}
        assert st["current_total_bytes"] == 2 * sum(single.values())
        reqs = [r.submit("fleet ledger") for r in reps]
        for q in reqs:
            assert q.done.wait(60.0)
        reps[0].stop()
        assert TP.hbm_stats()["current_bytes"] == single
    finally:
        for r in reps:
            r.stop()
    assert TP.hbm_stats()["current_total_bytes"] == 0
    assert TP.hbm_stats()["high_water_total_bytes"] == 2 * sum(single.values())
