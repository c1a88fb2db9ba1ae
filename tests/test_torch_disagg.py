"""Disaggregated prefill/decode lanes of the port's continuous decode
server (after tests/test_disagg.py's lane cases).

* disagg on and off serve equal streams across the grid disagg x tenant
  scheduling x prefix cache x paged x spec decode, held against the
  port's own off arm and JAX static ``generate`` (never the JAX
  continuous server);
* with a decode lane active, every pending prompt advances within
  ``ceil(pending / budget)`` ticks (``_prefill_lane``), and all of them
  advance without one;
* ``kv_migrated_blocks`` is exact (a paged request's block row, or its
  prompt's pieces on a dense pool), counted in the registry, and zero
  with the flag off; the ``migrate`` span event appears only under the
  flag; ``lane_stats()`` and the lane gauges quiesce to zero.

Every wait is bounded.
"""

import itertools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.engine import probes, tracing
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
NEW = 10
HEAD = "x" * 56
HP = [HEAD + f"q{k:02d}xx" for k in range(4)]
MIXED = ["a" * 70, "hello world", "b" * 41, "continuous batching", "c" * 33]


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
        for p in HP + MIXED}


def _chat(tparams, **kw):
    kw.setdefault("n_slots", 2)
    return DecoderChat(params=tparams, cfg=TCFG, tokenizer=TOK, max_new_tokens=NEW,
                       max_prompt_tokens=96, continuous=True, chunk_steps=4,
                       pipeline_depth=2, prefill_chunk=8, device="cpu", **kw)


def _serve(tparams, prompts, **kw):
    # a server's spans are found by its tag, which holds its id(): the
    # ring must not hold an earlier server's spans under a reused id
    tracing.reset_traces()
    chat = _chat(tparams, **kw)
    srv = chat.server
    try:
        reqs = chat.submit_batch(list(prompts))
        for r in reqs:
            assert r.done.wait(WAIT), "request hung"
        end = time.monotonic() + WAIT
        while (srv.lane_stats() != {"prefill": 0, "decode": 0}
               or srv._occ_published != srv.stats["chunks"]):
            assert time.monotonic() < end, "the lanes never quiesced"
            time.sleep(0.002)
        return reqs, dict(srv.stats), srv
    finally:
        chat.close()


GRID = list(itertools.product((False, True), repeat=4))


@pytest.mark.parametrize("tenant,prefix,paged,spec", GRID,
                         ids=["-".join(n for n, on in zip(("tenant", "prefix", "paged", "spec"), g)
                                       if on) or "plain" for g in GRID])
def test_disagg_grid_streams_equal(tparams, truth, tenant, prefix, paged, spec):
    kw = dict(prefix_cache=prefix, spec_decode=spec)
    if paged:
        kw.update(paged_kv=True, paged_kv_block=8)
    if tenant:
        kw.update(tenant_sched=True, tenant_weights="default:2")
    on, st_on, _ = _serve(tparams, HP, disagg=True, **kw)
    off, st_off, _ = _serve(tparams, HP, disagg=False, **kw)
    assert [r.tokens for r in on] == [r.tokens for r in off] == [truth[p] for p in HP]
    assert st_on["kv_migrated_blocks"] > 0 and st_off["kv_migrated_blocks"] == 0


def test_prefill_lane_round_robin_bound(tparams):
    chat = _chat(tparams, disagg=True, disagg_prefill_budget=2)
    chat.close()  # the loop is down: drive the lane choice by hand
    srv = chat.server
    assert srv.disagg and srv._prefill_budget == 2
    for pending in range(1, 9):
        srv._pending_prefill = {s: None for s in range(pending)}
        srv._prefill_rr = pending  # any cursor
        decoding = np.array([True] + [False] * (srv.n_slots - 1))
        bound = math.ceil(pending / 2)
        seen = set()
        for _ in range(bound):
            lane = srv._prefill_lane(decoding)
            assert len(lane) == min(2, pending)
            seen.update(lane)
        assert seen == set(range(pending)), pending
        # no decode lane to protect: every prompt advances every tick
        assert srv._prefill_lane(np.zeros(srv.n_slots, bool)) == list(range(pending))
    srv.disagg = False
    srv._pending_prefill = {s: None for s in range(5)}
    assert srv._prefill_lane(decoding) == list(range(5))
    srv._pending_prefill = {}


def _paged_need(srv, n):
    P, B = srv.prefill_chunk, srv.paged_block
    cover = min(srv.cache_len, -(-n // P) * P + NEW + (srv.pipeline_depth + 1) * srv._slack)
    return -(-cover // B)


@pytest.mark.parametrize("paged", [False, True])
def test_kv_migrated_blocks_exact_and_flag_only(tparams, paged):
    kw = dict(paged_kv=True, paged_kv_block=16) if paged else {}
    probes.REGISTRY.remove("kv_migrated_blocks")
    reqs, st, srv = _serve(tparams, MIXED, disagg=True, prefix_cache=False, **kw)
    lens = [len(TOK.encode(p)) for p in MIXED]
    if paged:
        want = sum(_paged_need(srv, n) for n in lens)
    else:
        # dense: prompts of more than one piece prefill in pieces and hand
        # over ceil(n / P) blocks; a one-piece prompt admits whole
        want = sum(-(-n // 8) for n in lens if n > 8)
    assert st["kv_migrated_blocks"] == want
    counted = probes.REGISTRY.labelled("kv_migrated_blocks", "server", kind="counter")
    assert counted[srv._trace_tag] == want
    migrated = [sum(e.get("blocks", 0) for e in s["events"] if e["name"] == "migrate")
                for s in srv.recent_traces()]
    assert sum(migrated) == want
    assert srv.lane_stats() == {"prefill": 0, "decode": 0}
    series = probes.REGISTRY.snapshot()["gauges"]["lane_occupancy"]["series"]
    lanes = {x["labels"]["lane"]: x["value"] for x in series
             if x["labels"]["server"] == srv._trace_tag}
    assert lanes == {"prefill": 0.0, "decode": 0.0}

    probes.REGISTRY.remove("kv_migrated_blocks")
    reqs_off, st_off, srv_off = _serve(tparams, MIXED, disagg=False, prefix_cache=False, **kw)
    assert [r.tokens for r in reqs_off] == [r.tokens for r in reqs]
    assert st_off["kv_migrated_blocks"] == 0
    assert "kv_migrated_blocks" not in probes.REGISTRY.snapshot()["counters"]
    assert not any(e["name"] == "migrate" for s in srv_off.recent_traces() for e in s["events"])
    assert srv_off.lane_stats() == {"prefill": 0, "decode": 0}


def test_disagg_budget_serves_equal_streams(tparams, truth):
    """A wider prefill lane (budget 3) and the default (1), 4 slots."""
    ref, _, _ = _serve(tparams, MIXED + HP, n_slots=4)
    for budget in (1, 3):
        out, st, _ = _serve(tparams, MIXED + HP, n_slots=4, disagg=True,
                            disagg_prefill_budget=budget)
        assert [r.tokens for r in out] == [r.tokens for r in ref]
        assert st["kv_migrated_blocks"] > 0
    assert [r.tokens for r in ref] == [truth[p] for p in MIXED + HP]
