"""Supervised serving of the port's continuous decode server (after
tests/test_chaos.py's serving cases).

Every stream is held against JAX static greedy ``generate`` on the same
weights (the JAX continuous server is not the reference, ROADMAP C) and
against the port's own chaos-off arm:

* the supervision arguments at their defaults and set but inert serve
  identical streams, dense and paged;
* a poisoned admission fails alone; a retried one completes;
* a chaos grid over ``decode.admit`` and ``decode.dispatch``, dense and
  paged: every request terminal, every unfailed stream equal to the
  chaos-off run and to JAX; a restart rebuilds the pool and the allocator
  (every block back but the prefix tree's), ``serve_restarts`` counts it;
* deadline and queue-bound shedding with the reason and ``retry_after``
  through ``DecoderChat``; the degradation ladder's clamp, spec gate and
  priority shed; a restart while a tier-2 promotion is staging;
* a serving thread that outlives its shutdown join is counted, and the
  fault counter families export under single ``_total`` names.

Every wait is bounded and asserted; backoff sleeps stay under 20 + 40 +
80 ms a server.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine import probes as JP
from pathway_tpu.internals.http_server import registry_text as j_registry_text
from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.engine import chaos, probes, slo
from pathway_tpu_torch.internals.errors import get_global_error_log
from pathway_tpu_torch.internals.http_server import registry_text
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.xpacks.llm import DecoderChat, decode_serve_error
from pathway_tpu_torch.xpacks.llm.llms import _ContinuousServer
from tests.utils import ToyCharTokenizer

JCFG = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=128, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=128, dtype=torch.float32)
WAIT = 60.0
NEW = 8
TOK = ToyCharTokenizer(32)
PROMPTS = ["hello world", "z" * 30, "abc", "continuous batching", "qrs tuv",
           "slot pool", "the quick brown fox", "x"]
POOLS = {
    "dense": dict(flash_prefill=True),
    "paged": dict(paged_kv=True, paged_kv_block=8, paged_kernel=True,
                  flash_prefill=True),
}
INERT = dict(serve_restarts=2, serve_retries=3, request_deadline_ms=600000.0,
             serve_queue=64, degradation=True)


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def truth(jparams):
    """JAX static greedy tokens of every prompt (one prompt per call)."""
    return {p: np.asarray(JD.generate(
        jparams, jnp.asarray([TOK.encode(p)], jnp.int32),
        jnp.ones((1, len(TOK.encode(p))), jnp.int32), JCFG, NEW))[0].tolist()
        for p in PROMPTS + ["poisoned", "healthy", "retry me"]}


@pytest.fixture(autouse=True)
def _defaults():
    chaos.configure()
    slo.configure()
    yield
    chaos.configure()
    slo.configure()


def _chat(tparams, pool="dense", **kw):
    kw.setdefault("n_slots", 2)
    return DecoderChat(params=tparams, cfg=TCFG, tokenizer=TOK, max_new_tokens=NEW,
                       max_prompt_tokens=32, continuous=True, chunk_steps=4,
                       pipeline_depth=2, prefill_chunk=8, device="cpu",
                       **POOLS[pool], **kw)


def _wait_all(reqs):
    for r in reqs:
        assert r.done.wait(WAIT), "request hung"


def _serve(tparams, pool="dense", prompts=PROMPTS, **kw):
    chat = _chat(tparams, pool, **kw)
    try:
        reqs = chat.submit_batch(prompts)
        _wait_all(reqs)
        return reqs, dict(chat.server.stats), chat.server
    finally:
        chat.close()
        assert not chat.server.thread.is_alive()


@pytest.mark.parametrize("pool", list(POOLS))
def test_inert_knobs_serve_identical_streams(tparams, truth, pool):
    base, st, _ = _serve(tparams, pool)
    assert [r.tokens for r in base] == [truth[p] for p in PROMPTS]
    assert st["shed"] == st["restarts"] == st["request_failures"] == 0
    armed, ast, srv = _serve(tparams, pool, **INERT)
    assert srv._degrade is slo.get_degradation_controller()
    assert [r.text for r in armed] == [r.text for r in base]
    assert [r.tokens for r in armed] == [r.tokens for r in base]
    assert ast["shed"] == ast["restarts"] == ast["request_retries"] == 0
    off, _, srv = _serve(tparams, pool, degradation=False)
    assert srv._degrade is None
    assert [r.tokens for r in off] == [r.tokens for r in base]


def test_poisoned_request_fails_alone(tparams, truth):
    chat = _chat(tparams, serve_restarts=1, serve_retries=0)
    try:
        srv = chat.server
        srv._chaos_admit = chaos.ChaosSite("decode.admit", 1.0, 0)
        handles = chat.submit_batch(["poisoned"])
        bad = chat.resolve_batch([handles])[0][0]
        assert decode_serve_error(bad) == {"reason": "failed"}
        assert handles[0].error_reason == "failed" and srv.failed is None
        srv._chaos_admit = None
        good = chat.submit_batch(["healthy"])[0]
        _wait_all([good])
        assert good.tokens == truth["healthy"]
        assert srv.stats["request_failures"] == 1 and srv.stats["restarts"] == 0
    finally:
        chat.close()


class _FailOnce:
    """A site stand-in that faults on its first pass only (or when armed)."""

    def __init__(self, name: str, armed: bool = True):
        self.name, self.armed, self.calls = name, armed, 0

    def maybe_fail(self):
        self.calls += 1
        if self.armed:
            self.armed = False
            raise chaos.InjectedFault(self.name, self.calls)


def test_retry_budget_recovers(tparams, truth):
    chat = _chat(tparams, serve_restarts=1, serve_retries=3)
    try:
        srv = chat.server
        srv._chaos_admit = _FailOnce("decode.admit")
        req = chat.submit_batch(["retry me"])[0]
        _wait_all([req])
        assert req.tokens == truth["retry me"] and req.retries == 1
        assert srv.stats["request_retries"] == 1 and srv.stats["request_failures"] == 0
    finally:
        chat.close()


def test_unsupervised_failure_latches(tparams):
    chat = _chat(tparams)  # serve_restarts=0, the default
    try:
        srv = chat.server
        srv._chaos_admit = _FailOnce("decode.admit")
        req = chat.submit_batch(["poisoned"])[0]
        _wait_all([req])
        assert req.text is None and isinstance(srv.failed, chaos.InjectedFault)
        with pytest.raises(RuntimeError, match="died"):
            chat.submit_batch(["after the latch"])
    finally:
        chat.close()


# (site, rate, seed) cells with a handful of faults each: admission faults
# cost no backoff; at most three dispatch faults keep the backoff under
# 20 + 40 + 80 ms
GRID = [("decode.admit", 0.0, 7), ("decode.admit", 0.3, 7),
        ("decode.dispatch", 0.15, 3)]


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("site,rate,seed", GRID)
def test_chaos_grid_every_request_terminal(tparams, truth, pool, site, rate, seed):
    chaos.configure(rate=rate, seed=seed, sites=site)
    probes.REGISTRY.remove("serve_restarts", "requests_isolated")
    reqs, st, srv = _serve(tparams, pool, serve_restarts=3, serve_retries=4)
    served = [r for r in reqs if r.text is not None]
    for p, r in zip(PROMPTS, reqs):
        assert r.done.is_set()
        if r.text is not None:
            assert r.tokens == truth[p], p
        else:
            assert r.error_reason in ("failed", None)
    restarts = probes.REGISTRY.labelled("serve_restarts", "server").get(srv._trace_tag, 0)
    assert st["restarts"] == restarts
    site_obj = srv._chaos_admit if site == "decode.admit" else srv._chaos_dispatch
    if rate == 0.0:
        assert site_obj is None and len(served) == len(PROMPTS)
        assert st["restarts"] == st["request_retries"] == 0
        return
    faults = st["restarts"] + st["request_retries"] + st["request_failures"]
    assert site_obj is not None and faults >= 1
    if srv.failed is None:
        # every block back in the allocator but those the tree pins
        if srv.paged_kv:
            assert srv._allocator.n_allocated == srv.prefix.used_blocks
        assert len(served) + st["request_failures"] == len(PROMPTS)


@pytest.mark.parametrize("pool", list(POOLS))
def test_restart_rebuilds_the_pool(tparams, truth, pool):
    """One dispatch fault mid-burst: the loop restarts once, the pool and
    allocator are fresh, every interrupted request re-decodes to JAX's
    tokens."""
    chat = _chat(tparams, pool, serve_restarts=2, serve_retries=2)
    try:
        srv = chat.server
        pool0 = srv.pool
        fault = _FailOnce("decode.dispatch", armed=False)
        srv._chaos_dispatch = fault
        reqs = chat.submit_batch(PROMPTS[:4])
        fault.armed = True
        _wait_all(reqs)
        assert srv.stats["restarts"] == 1 and srv.failed is None
        assert srv.pool is not pool0
        assert [r.tokens for r in reqs] == [truth[p] for p in PROMPTS[:4]]
        assert any(r.retries == 1 for r in reqs)
        assert srv.stats["request_retries"] >= 1
        if srv.paged_kv:
            assert srv._allocator.n_allocated == srv.prefix.used_blocks
        assert any("supervised restart" in e["message"]
                   for e in get_global_error_log().entries)
    finally:
        chat.close()


def test_restart_budget_spent_latches(tparams):
    chat = _chat(tparams, serve_restarts=2, serve_retries=5)
    try:
        srv = chat.server
        srv._chaos_dispatch = chaos.ChaosSite("decode.dispatch", 1.0, 0)
        reqs = chat.submit_batch(PROMPTS[:2])
        _wait_all(reqs)
        assert srv.stats["restarts"] == 3  # every attempt crashed and recovered
        assert isinstance(srv.failed, chaos.InjectedFault)
        assert all(r.text is None for r in reqs)
    finally:
        chat.close()


# ------------------------------------------------------------- shedding


def test_deadline_shedding(tparams):
    chat = _chat(tparams, n_slots=1, request_deadline_ms=1.0)
    try:
        handles = chat.submit_batch(PROMPTS)
        texts = chat.resolve_batch([handles])[0]
        shed = [r for r in handles if r.error_reason in ("shed:deadline",
                                                         "shed:deadline_inflight")]
        assert any(r.error_reason == "shed:deadline" for r in shed)
        for r, t in zip(handles, texts):
            if r in shed:
                assert r.text is None and r.retry_after == 1.0
                assert decode_serve_error(t) == {"reason": r.error_reason,
                                                 "retry_after": 1.0}
        assert chat.server.stats["shed"] == len(shed)
    finally:
        chat.close()


def test_deadline_admits_nothing_late(tparams, truth):
    """A deadline past every request's wait sheds nothing; one between
    sheds only queued requests whose deadline lapsed, and every admitted
    request's admission precedes its deadline."""
    reqs, st, _ = _serve(tparams, request_deadline_ms=600000.0)
    assert st["shed"] == 0 and [r.tokens for r in reqs] == [truth[p] for p in PROMPTS]
    chat = _chat(tparams, n_slots=1, request_deadline_ms=30.0)
    try:
        reqs = chat.submit_batch(PROMPTS)
        _wait_all(reqs)
        for p, r in zip(PROMPTS, reqs):
            if r.text is not None:
                assert r.tokens == truth[p]
        ids = {r.span.request_id for r in reqs}
        spans = {s["id"]: s for s in chat.recent_traces() if s["id"] in ids}
        assert len(spans) == len(PROMPTS)
        for s in spans.values():
            admit = [e["t_ms"] for e in s["events"] if e["name"] == "admit"]
            assert not admit or admit[0] <= 30.0 + 1.0
    finally:
        chat.close()


def test_queue_bound_shedding(tparams, truth):
    probes.REGISTRY.remove("requests_shed")
    chat = _chat(tparams, n_slots=1, serve_queue=1)
    try:
        handles = chat.submit_batch(PROMPTS)
        texts = chat.resolve_batch([handles])[0]
        shed = [i for i, r in enumerate(handles) if r.error_reason == "shed:queue_full"]
        assert shed and len(shed) < len(PROMPTS)
        for i, (r, t) in enumerate(zip(handles, texts)):
            if i in shed:
                assert decode_serve_error(t) == {"reason": "shed:queue_full",
                                                 "retry_after": 1.0}
            else:
                assert r.tokens == truth[PROMPTS[i]]
        assert probes.REGISTRY.labelled("requests_shed", "reason") == {
            "queue_full": float(len(shed))}
        assert chat.server.stats["shed"] == len(shed)
    finally:
        chat.close()


# ---------------------------------------------------- degradation ladder


def test_ladder_levels_change_admission(tparams, truth):
    chat = _chat(tparams, spec_decode=True, chunk_autotune=False)
    try:
        srv = chat.server
        assert srv.spec_decode
        srv._degrade = None  # pin the level by hand
        srv._degradation_level = 1
        r1 = chat.submit_batch(["slot pool"])[0]
        _wait_all([r1])
        assert r1.max_new == NEW // 2 and r1.tokens == truth["slot pool"][:NEW // 2]

        srv._degradation_level = 2
        spec0 = srv.stats["spec_dispatches"]
        r2 = chat.submit_batch(["qrs tuv"])[0]
        _wait_all([r2])
        assert srv.stats["spec_dispatches"] == spec0  # plain chunks only
        assert r2.tokens == truth["qrs tuv"][:NEW // 2]

        srv._degradation_level = 3
        low = chat.submit_batch(["best effort"], priority=0)[0]
        normal = chat.submit_batch(["abc"])[0]
        _wait_all([low, normal])
        assert low.error_reason == "shed:degraded" and low.retry_after == 1.0
        assert normal.tokens == truth["abc"][:NEW // 2]

        srv._degradation_level = 0  # recovery: full budgets and spec again
        r0 = chat.submit_batch(["hello world"])[0]
        _wait_all([r0])
        assert r0.tokens == truth["hello world"]
        assert srv.stats["spec_dispatches"] > spec0 and srv.stats["shed"] == 1
    finally:
        chat.close()


def test_ladder_driven_by_a_failing_objective(tparams, truth):
    """An injected clock and an objective that always fails step the
    shared controller to 3; the server reads it at its next tick."""
    clock = [1000.0]
    wd = slo.SloWatchdog([slo.Objective("ttft_p95", "ceiling", 1.0,
                                        sample=lambda: 1e9)], clock=lambda: clock[0])
    ctl = slo.DegradationController(wd, step_s=5.0)
    chat = _chat(tparams)
    try:
        srv = chat.server
        for want in (1, 2, 3):
            wd.tick()
            assert ctl.evaluate() == want
            clock[0] += 5.0
        srv._degrade = ctl
        end = time.monotonic() + WAIT  # the idle loop reads the ladder each tick
        while srv._degradation_level != 3 and time.monotonic() < end:
            time.sleep(0.005)
        assert srv._degradation_level == 3
        low = chat.submit_batch(["x"], priority=0)[0]
        high = chat.submit_batch(["abc"], priority=1)[0]
        _wait_all([low, high])
        assert low.error_reason == "shed:degraded"
        assert high.tokens == truth["abc"][:NEW // 2]
    finally:
        chat.close()


# ------------------------------------------- restart during a promotion

T2 = [c * 24 + "?" for c in "abcdef"]


@pytest.mark.parametrize("pool", list(POOLS))
def test_restart_while_a_promotion_stages(jparams, tparams, pool):
    """A tier-2 hit's promotion is held in its stage worker while a
    dispatch fault restarts the loop: the requeued request is released
    from its hold, every request finishes with JAX's tokens, and the late
    promotion lands in the rebuilt tree."""
    from pathway_tpu.xpacks.llm.llms import TPUDecoderChat

    prompts = T2 + ["a" * 24 + "?", "zq"]
    static = TPUDecoderChat(params=jparams, cfg=JCFG, tokenizer=ToyCharTokenizer(64),
                            max_new_tokens=NEW, temperature=0.0, max_prompt_tokens=32)
    want = dict(zip(prompts, static.__wrapped__(prompts, max_new_tokens=NEW)))
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(64),
                       max_new_tokens=NEW, max_prompt_tokens=32, continuous=True,
                       n_slots=4, chunk_steps=4, pipeline_depth=2, prefill_chunk=8,
                       prefix_cache_mb=0.013, prefix_t2_mb=0.1, serve_restarts=2,
                       serve_retries=2, device="cpu", **POOLS[pool])
    srv = chat.server
    gate = threading.Event()
    stage = srv._promote_worker._fn

    def held(item):
        assert gate.wait(WAIT)
        stage(item)

    srv._promote_worker._fn = held
    try:
        for p in T2:  # six heads through a 3-block tier 1: the first demotes
            r = chat.submit_batch([p])[0]
            _wait_all([r])
            assert r.text == want[p]
        fault = _FailOnce("decode.dispatch", armed=False)
        srv._chaos_dispatch = fault
        hit = chat.submit_batch([prompts[6]])[0]
        for _ in range(int(WAIT / 0.01)):  # the hit is waiting on its promotion
            if srv.stats["t2_hit_requests"] >= 1 and srv._t2_waiting:
                break
            threading.Event().wait(0.01)
        assert srv._t2_waiting
        fault.armed = True
        other = chat.submit_batch([prompts[7]])[0]  # its dispatch faults
        _wait_all([hit, other])
        assert srv.stats["restarts"] == 1 and srv.failed is None
        assert hit.text == want[prompts[6]] and other.text == want[prompts[7]]
        gate.set()
        assert srv.t2_drain(timeout=WAIT)
        if srv.paged_kv:
            assert srv._allocator.n_allocated == srv.prefix.used_blocks
    finally:
        gate.set()
        chat.close()


# ------------------------------------------------------------- shutdown


def test_shutdown_counts_a_leaked_thread():
    release = threading.Event()
    srv = object.__new__(_ContinuousServer)
    srv._stop = False
    srv.wake = threading.Event()
    srv.lock = threading.Lock()
    srv.stats = {"leaked_thread": 0}
    srv.thread = threading.Thread(target=release.wait, args=(WAIT,), daemon=True)
    srv.thread.start()
    n0 = len(get_global_error_log().entries)
    try:
        srv.shutdown(timeout=0.2)
        assert srv.stats["leaked_thread"] == 1
        assert "still alive" in get_global_error_log().entries[n0]["message"]
    finally:
        release.set()
        srv.thread.join(WAIT)
        assert not srv.thread.is_alive()


def test_fault_counter_families_export_as_jax():
    """Counter families carry no ``_total`` suffix of their own, so they
    scrape once-suffixed, and the port's text equals JAX's."""
    fams = ("requests_shed", "serve_restarts", "requests_isolated", "degradation_level")
    port_reg, jax_reg = probes.MetricsRegistry(), JP.MetricsRegistry()
    for reg in (port_reg, jax_reg):
        reg.counter_add("requests_shed", reason="deadline")
        reg.counter_add("requests_shed", 2, reason="queue_full")
        reg.counter_add("serve_restarts", server="decode")
        reg.counter_add("requests_isolated", outcome="failed")
        reg.counter_add("requests_isolated", 3, outcome="retried")
        reg.gauge_set("degradation_level", 2.0)
    text = registry_text(port_reg.snapshot())
    assert text == j_registry_text(jax_reg.snapshot())
    assert 'pathway_tpu_requests_shed_total{reason="deadline"} 1' in text
    assert 'pathway_tpu_serve_restarts_total{server="decode"} 1' in text
    assert 'pathway_tpu_requests_isolated_total{outcome="retried"} 3' in text
    assert "pathway_tpu_degradation_level 2" in text
    assert "_total_total" not in text
    for fam in fams:
        assert probes.METRIC_FAMILIES[fam] == JP.METRIC_FAMILIES[fam]
