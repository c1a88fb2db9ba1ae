"""Tenant scheduling and budget preemption of the port's continuous
decode server (after tests/test_disagg.py's scheduler and preemption
cases).

* ``engine.slo.TenantScheduler`` against JAX's: ``parse_weights`` on the
  malformed cases, a seeded random sequence of ``select`` / ``charge`` /
  ``credit`` with the same indices and ``stats()``, the weighted-fair
  ratio, FIFO within a tenant, budget eligibility and starvation freedom;
* serving with the scheduler off and on (one tenant, or weights and no
  budget): streams equal to each other and to JAX static ``generate``;
* preemption, paged and dense: the over-budget tenant's newest request
  parks and re-queues, streams equal to the unscheduled server's and to
  JAX (the re-prefill pieces start on a block boundary, a multiple of the
  piece, so they are the original pieces and the streams are equal token
  for token), ``kv_parked_bytes`` back to 0, every block back in the
  allocator, the sentinel block still zero, every charge credited back;
* a row ``_unpark`` rejects (the ladder's level-1 clamp shrank the
  request) is released; a supervised restart with a parked row releases
  it; a deadline shed of a parked request and a ``deadline_inflight``
  shed of an unparked one release their rows;
* the ``tenant`` argument through ``DecoderChat.submit_batch`` reaches
  ``tenant_depths()``.

Every wait is bounded.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine import slo as JS
from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.engine import chaos, probes, slo, tracing
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.utils import ToyCharTokenizer

JCFG = JD.DecoderConfig(vocab_size=128, hidden=64, layers=2, heads=4,
                        intermediate=128, max_position=256, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=64, layers=2, heads=4,
                        intermediate=128, max_position=256, dtype=torch.float32)
TOK = ToyCharTokenizer(96)
WAIT = 60.0
NEW = 16
PROMPTS = ["hello world", "continuous batching", "abc", "qrs tuv", "slot pool",
           "the quick brown fox"]
PROMPTS_P = ["pa one xxxx", "pa two yyyy", "pb one zzzz"]
POOLS = {
    "paged": dict(paged_kv=True, paged_kv_block=8),
    # pieces of 8 for every prompt (none fits one whole-prompt admission,
    # whose batching would tie a stream to its neighbours), no prefix hit
    # (a dense hit changes the padding)
    "dense": dict(prefix_cache=False),
}
# the budget lies strictly between one and two requests' decode budget:
# both tenant-a requests admit, and only then is "a" over budget
SCHED = dict(tenant_sched=True, tenant_budget=NEW + 2, tenant_weights="a:2,b:1")


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def truth(jparams):
    return {p: np.asarray(JD.generate(
        jparams, jnp.asarray([TOK.encode(p)], jnp.int32),
        jnp.ones((1, len(TOK.encode(p))), jnp.int32), JCFG, NEW))[0].tolist()
        for p in PROMPTS + PROMPTS_P}


@pytest.fixture(autouse=True)
def _defaults():
    chaos.configure()
    slo.configure()
    yield
    chaos.configure()
    slo.configure()


def _chat(tparams, **kw):
    # a server's spans and gauges are found by its tag, which holds its
    # id(): nothing of an earlier server may linger under a reused id
    tracing.reset_traces()
    probes.REGISTRY.remove("kv_parked_bytes", "tenant_queue_depth")
    kw.setdefault("n_slots", 2)
    return DecoderChat(params=tparams, cfg=TCFG, tokenizer=TOK, max_new_tokens=NEW,
                       max_prompt_tokens=96, continuous=True, chunk_steps=4,
                       pipeline_depth=2, prefill_chunk=8, device="cpu", **kw)


def _wait(reqs):
    for r in reqs:
        assert r.done.wait(WAIT), "request hung"


def _until(cond, what):
    end = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.002)


# ---- the scheduler against JAX's -------------------------------------------


def test_parse_weights_equals_jax():
    for spec in ("prod:4,batch:1", " a : 2 , b:0.5 ", "x,:3,a:zz,b:-1,c:2", "", None,
                 "a:1,a:3", "z:0", "t:1e2,u:inf"):
        assert slo.TenantScheduler.parse_weights(spec) == JS.TenantScheduler.parse_weights(spec)
    pw = slo.TenantScheduler.parse_weights
    assert pw("x,:3,a:zz,b:-1,c:2") == {"c": 2.0} and pw("") == {}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("budget", [0, 20])
def test_random_sequence_equals_jax(seed, budget):
    rng = np.random.default_rng(seed)
    weights = {"a": 3.0, "b": 1.0, "c": 0.5}
    t = slo.TenantScheduler(weights=weights, budget_tokens=budget, clock=lambda: 0.0)
    j = JS.TenantScheduler(weights=weights, budget_tokens=budget, clock=lambda: 0.0)
    tenants = ["a", "b", "c", "d"]
    for _ in range(400):
        op = rng.integers(0, 4)
        if op == 0:
            entries = [(tenants[rng.integers(0, 4)], int(rng.integers(0, 12)))
                       for _ in range(rng.integers(0, 8))]
            peek = bool(rng.integers(0, 4) == 0)
            assert t.select(entries, charge=not peek) == j.select(entries, charge=not peek)
        elif op == 1:
            who, n = tenants[rng.integers(0, 4)], int(rng.integers(1, 16))
            t.charge(who, n)
            j.charge(who, n)
        elif op == 2:
            who, n = tenants[rng.integers(0, 4)], int(rng.integers(1, 16))
            t.credit(who, n)
            j.credit(who, n)
        else:
            who = tenants[rng.integers(0, 4)]
            assert t.over_budget(who) == j.over_budget(who)
            assert t.inflight(who) == j.inflight(who)
            assert t.weight(who) == j.weight(who)
        assert t.stats() == j.stats()


def test_weighted_fair_pop_ratio():
    clk = [0.0]
    s = slo.TenantScheduler(weights={"a": 2.0, "b": 1.0}, clock=lambda: clk[0])
    served = {"a": 0, "b": 0}
    entries = [("a", 8), ("b", 8)]
    for _ in range(90):
        clk[0] += 1.0
        served[entries[s.select(entries)][0]] += 1
    assert served["a"] + served["b"] == 90
    assert served["a"] / served["b"] == pytest.approx(2.0, rel=0.15)


def test_select_pops_fifo_oldest_of_chosen_tenant():
    s = slo.TenantScheduler(clock=lambda: 0.0)
    assert s.select([("a", 4), ("b", 4), ("a", 2)]) in (0, 1)
    s2 = slo.TenantScheduler(clock=lambda: 0.0)
    s2.select([("a", 4)])
    assert s2.select([("a", 4), ("b", 4), ("b", 2)]) == 1
    assert s2.select([]) is None


def test_budget_eligibility_and_release():
    s = slo.TenantScheduler(budget_tokens=10, clock=lambda: 0.0)
    assert not s.over_budget("a")
    s.charge("a", 10)
    assert s.over_budget("a")
    assert s.select([("a", 4)]) is None
    assert s.select([("a", 4), ("b", 4)]) == 1
    s.credit("a", 10)
    assert not s.over_budget("a") and s.inflight("a") == 0
    assert s.select([("a", 4)]) == 0
    s0 = slo.TenantScheduler(budget_tokens=0, clock=lambda: 0.0)
    s0.charge("a", 10 ** 6)
    assert not s0.over_budget("a")


def test_starvation_freedom_and_no_burst_credit():
    clk = [0.0]
    s = slo.TenantScheduler(weights={"big": 100.0, "small": 1.0}, clock=lambda: clk[0])
    for _ in range(50):
        clk[0] += 1.0
        s.select([("big", 8)])
    entries = [("big", 8), ("small", 8)]
    small = 0
    for _ in range(250):
        clk[0] += 1.0
        small += entries[s.select(entries)][0] == "small"
    assert 1 <= small <= 6


# ---- serving with the scheduler off and on ------------------------------------


def _serve_tenants(tparams, pool, **kw):
    chat = _chat(tparams, **POOLS[pool], **kw)
    try:
        reqs = []
        for i, p in enumerate(PROMPTS):
            reqs += chat.submit_batch([p], tenant="ab"[i % 2])
        _wait(reqs)
        srv = chat.server
        return [r.tokens for r in reqs], dict(srv.stats), srv
    finally:
        chat.close()


@pytest.mark.parametrize("pool", list(POOLS))
def test_scheduler_on_and_off_serve_equal_streams(tparams, truth, pool):
    off, st, srv = _serve_tenants(tparams, pool)
    assert srv._tenants is None and st["preemptions"] == 0
    assert off == [truth[p] for p in PROMPTS]
    one, st, srv = _serve_tenants(tparams, pool, tenant_sched=True,
                                  tenant_weights="default:1")
    assert srv._tenants is not None and st["preemptions"] == 0
    assert one == off
    two, st, srv = _serve_tenants(tparams, pool, tenant_sched=True, tenant_weights="a:3,b:1")
    assert two == off and st["preemptions"] == 0
    assert srv._tenants.stats()["inflight"] == {} and srv._charged == {}
    spans = srv.recent_traces()
    assert sorted(s["attrs"]["tenant"] for s in spans) == ["a", "a", "a", "b", "b", "b"]


def test_tenant_seam_reaches_tenant_depths(tparams, truth):
    chat = _chat(tparams, tenant_sched=True, tenant_weights="a:3,b:1")
    try:
        srv = chat.server
        srv._take_admissions = lambda: []  # hold the queue
        ra = chat.submit_batch(PROMPTS[:2], tenant="a")
        rb = chat.submit_batch(PROMPTS[2:3], tenant="b")
        rd = chat.submit_batch(PROMPTS[3:4])
        assert srv.tenant_depths() == {"a": 2, "b": 1, "default": 1}
        assert [r.tenant for r in ra + rb + rd] == ["a", "a", "b", "default"]
        del srv._take_admissions
        srv.wake.set()
        _wait(ra + rb + rd)
        assert [r.tokens for r in ra + rb + rd] == [truth[p] for p in PROMPTS[:4]]
        assert srv.tenant_depths() == {}
        _until(lambda: srv._occ_published == srv.stats["chunks"], "the idle gauges")
        depth = probes.REGISTRY.labelled("tenant_queue_depth", "tenant", kind="gauge")
        assert depth == {"a": 0.0, "b": 0.0, "default": 0.0}
    finally:
        chat.close()


# ---- preemption ----------------------------------------------------------------


def _preempt_run(tparams, pool, sched, hook=None, **kw):
    """Two tenant-a requests fill both slots past a's budget, then tenant b
    arrives: the newest a request is preempted. ``hook(srv)`` runs before
    the burst."""
    chat = _chat(tparams, **POOLS[pool], **(SCHED if sched else {}), **kw)
    srv = chat.server
    try:
        warm = chat.submit_batch(["warmup xx"])[0]
        assert warm.done.wait(WAIT)
        if hook is not None:
            hook(srv)
        base = dict(srv.stats)
        ra = [chat.submit_batch([p], tenant="a")[0] for p in PROMPTS_P[:2]]
        _until(lambda: srv.stats["admitted"] - base["admitted"] >= 2, "two admissions")
        rb = chat.submit_batch([PROMPTS_P[2]], tenant="b")[0]
        reqs = ra + [rb]
        _wait(reqs)
        stats = {k: srv.stats[k] - base.get(k, 0) for k in srv.stats}
        _until(lambda: srv.lane_stats() == {"prefill": 0, "decode": 0}, "idle lanes")
        return reqs, stats, srv
    finally:
        chat.close()


def _check_released(srv):
    """Every parked byte and block is back, the sentinel is untouched and
    every charge was credited."""
    assert probes.kv_parked_value(server=srv._trace_tag) in (None, 0.0)
    assert srv._parked == {} and srv._parked_blocks == 0
    if srv._allocator is not None:
        srv.prefix_reset()
        assert srv._allocator.n_free == srv._total_blocks - 1
        assert not srv.pool["kb"][:, 0].any() and not srv.pool["vb"][:, 0].any()
    if srv._tenants is not None:
        assert srv._tenants.stats()["inflight"] == {} and srv._charged == {}


@pytest.mark.parametrize("pool", list(POOLS))
def test_budget_preemption_parks_and_requeues(tparams, truth, pool):
    ref, ref_st, _ = _preempt_run(tparams, pool, sched=False)
    assert ref_st["preemptions"] == 0
    assert [r.tokens for r in ref] == [truth[p] for p in PROMPTS_P]
    parked_seen = []

    def watch(srv):
        orig = srv._preempt_request

        def hooked(slot, req, active):
            orig(slot, req, active)
            parked_seen.append((probes.kv_parked_value(server=srv._trace_tag),
                                len(srv._parked)))
        srv._preempt_request = hooked

    out, st, srv = _preempt_run(tparams, pool, sched=True, hook=watch)
    assert st["preemptions"] >= 1
    assert st["shed"] == st["request_failures"] == 0
    assert [r.tokens for r in out] == [r.tokens for r in ref]
    if pool == "paged":
        # the victim's row parked (its bytes on the gauge) and came back
        assert parked_seen[0][0] > 0 and parked_seen[0][1] == 1
        assert st["unparked"] >= 1
        victim = out[1]
        names = {e["name"] for s in srv.recent_traces() for e in s["events"]}
        assert {"preempt", "unpark"} <= names
        assert victim.seq > out[0].seq
    else:
        assert parked_seen[0] == (None, 0) or parked_seen[0][1] == 0
        assert st["unparked"] == 0
    counted = probes.REGISTRY.labelled("preemptions", "tenant", kind="counter")
    assert counted.get("a", 0) >= st["preemptions"]
    _check_released(srv)


def test_unpark_rejects_a_clamped_row_and_releases_it(tparams, truth):
    """After the preemption the ladder reaches level 1: the re-admission
    clamps max_new to half, the parked row is too long for it, and the
    request admits afresh (its row released)."""
    released = []

    def clamp(srv):
        orig, orig_unpark = srv._preempt_request, srv._unpark

        def hooked(slot, req, active):
            orig(slot, req, active)
            srv._degrade = None
            srv._degradation_level = 1

        def unpark(slot, req, e, n, row):
            ok = orig_unpark(slot, req, e, n, row)
            released.append((ok, list(row)))
            return ok
        srv._preempt_request, srv._unpark = hooked, unpark

    out, st, srv = _preempt_run(tparams, "paged", sched=True, hook=clamp)
    assert st["preemptions"] >= 1 and st["unparked"] == 0
    assert released and not released[0][0]
    assert out[1].tokens == truth[PROMPTS_P[1]][:NEW // 2]
    assert out[0].tokens == truth[PROMPTS_P[0]]
    _check_released(srv)


def test_restart_releases_parked_rows(tparams, truth):
    """A loop crash while a preempted request waits parked: the restart
    releases its row into the old allocator before the rebuild, and every
    request still completes with its stream."""
    seen = {}

    class FaultWhileParked:
        def __init__(self, srv):
            self.srv = srv

        def maybe_fail(self):
            srv = self.srv
            if srv._parked and "old" not in seen:
                seen["old"] = srv._allocator
                seen["rows"] = [list(r) for r in srv._parked.values()]
                seen["refs"] = {i: srv._allocator._refs[i] for r in seen["rows"] for i in r}
                raise chaos.InjectedFault("decode.dispatch", 1)

    def arm(srv):
        srv._chaos_dispatch = FaultWhileParked(srv)

    out, st, srv = _preempt_run(tparams, "paged", sched=True, hook=arm,
                                serve_restarts=1, serve_retries=2)
    assert st["restarts"] == 1 and "old" in seen
    old = seen["old"]
    assert old is not srv._allocator
    for i, n in seen["refs"].items():
        assert old._refs.get(i, 0) == n - 1
    assert [r.tokens for r in out] == [truth[p] for p in PROMPTS_P]
    _check_released(srv)


def test_deadline_shed_of_a_parked_request_releases_its_row(tparams):
    def lapse(srv):
        orig = srv._preempt_request

        def hooked(slot, req, active):
            orig(slot, req, active)
            req.deadline = 0.0  # lapses while parked at the queue head
        srv._preempt_request = hooked

    out, st, srv = _preempt_run(tparams, "paged", sched=True, hook=lapse,
                                request_deadline_ms=600000.0)
    assert st["preemptions"] == 1
    assert out[1].error_reason == "shed:deadline" and out[1].text is None
    assert out[0].text is not None and out[2].text is not None
    _check_released(srv)


def test_deadline_inflight_of_an_unparked_request_releases_its_row(tparams):
    def lapse(srv):
        orig = srv._unpark

        def unpark(slot, req, e, n, row):
            ok = orig(slot, req, e, n, row)
            req.deadline = 0.0  # lapses after its re-admission
            return ok
        srv._unpark = unpark

    out, st, srv = _preempt_run(tparams, "paged", sched=True, hook=lapse,
                                request_deadline_ms=600000.0)
    assert st["unparked"] >= 1
    assert out[1].error_reason == "shed:deadline_inflight"
    assert out[0].text is not None and out[2].text is not None
    _check_released(srv)


def test_shutdown_releases_parked_rows(tparams):
    """A server shut down with a request parked: the loop's sweep fails
    the waiter and releases its row."""
    chat = _chat(tparams, **POOLS["paged"], **SCHED)
    srv = chat.server
    stop = threading.Event()
    orig = srv._preempt_request

    def hooked(slot, req, active):
        orig(slot, req, active)
        srv._take_admissions = lambda: []  # nobody admits again
        stop.set()
    srv._preempt_request = hooked
    try:
        ra = [chat.submit_batch([p], tenant="a")[0] for p in PROMPTS_P[:2]]
        _until(lambda: srv.stats["admitted"] >= 2, "two admissions")
        rb = chat.submit_batch([PROMPTS_P[2]], tenant="b")[0]
        assert stop.wait(WAIT)
        assert srv._parked
    finally:
        chat.close()
    _wait(ra + [rb])
    assert rb.text is None and ra[1].text is None
    assert srv._parked == {} and probes.kv_parked_value(server=srv._trace_tag) == 0.0
    assert srv._tenants.stats()["inflight"] == {}
