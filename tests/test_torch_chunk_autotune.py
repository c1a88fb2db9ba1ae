"""Chunk-steps autotune in the port's continuous server (the JAX server's
``_pick_steps`` and its two EMAs, on by default as
``PATHWAY_TPU_CHUNK_AUTOTUNE``).

``_pick_steps`` is held case by case against the JAX rule with the EMAs set
by hand (no sleeps); the arrival-gap and per-step wall EMAs are driven by a
fake clock. Autotune moves chunk boundaries only: a staggered burst serves
the same greedy tokens as JAX STATIC ``generate`` with autotune on and off,
with spec decode on (the default) and off. Every wait is bounded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.xpacks.llm import DecoderChat
from pathway_tpu_torch.xpacks.llm import llms
from tests.utils import ToyCharTokenizer

_DIMS = dict(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
             max_position=128)
JCFG = JD.DecoderConfig(**_DIMS, dtype=jnp.float32)
TCFG = TD.DecoderConfig(**_DIMS, dtype=torch.float32)
PROMPTS = ["hello world", "continuous batching", "abc", "qrs tuv", "slot pool",
           "zzz", "the quick brown fox", "a"]
NEW = 10


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


def _server(tparams, **kw):
    """A constructed server whose loop has already stopped, so the test
    owns its host state."""
    kw.setdefault("chunk_steps", 16)
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(),
                       max_new_tokens=4, continuous=True, n_slots=2,
                       max_prompt_tokens=16, device="cpu", **kw)
    chat.close()
    assert not chat.server.thread.is_alive()
    return chat.server


@pytest.mark.parametrize("chunk_steps,cands", [
    (16, [16, 8, 4]), (32, [32, 16, 8, 4]), (12, [12, 6]), (6, [6]), (4, [4]),
    (2, [2]), (1, [1]),
])
def test_candidates_are_halvings_down_to_four(tparams, chunk_steps, cands):
    srv = _server(tparams, chunk_steps=chunk_steps)
    assert srv.chunk_autotune and srv._step_cands == cands
    assert max(cands) == chunk_steps <= srv._slack


def test_pick_steps_table(tparams):
    srv = _server(tparams)  # candidates [16, 8, 4]
    # no estimate yet: the full chunk, with or without the wall EMA
    assert srv._pick_steps(0) == 16
    srv._step_wall_ema = 0.001
    assert srv._pick_steps(0) == 16
    # queue pressure: the smallest, whatever the EMAs say
    srv._arrival_ema = 1.0
    assert srv._pick_steps(1) == 4 and srv._pick_steps(7) == 4
    # the largest candidate whose wall fits one arrival gap
    for gap, want in ((1.0, 16), (0.016, 16), (0.0159, 8), (0.008, 8),
                      (0.0079, 4), (0.004, 4), (0.001, 4)):
        srv._arrival_ema = gap
        assert srv._pick_steps(0) == want, gap
    srv._step_wall_ema = 0.0  # a zero wall estimate is no estimate
    assert srv._pick_steps(0) == 16
    srv._step_wall_ema = None
    assert srv._pick_steps(0) == 16
    # off, or a single candidate: always chunk_steps
    off = _server(tparams, chunk_autotune=False)
    off._arrival_ema, off._step_wall_ema = 0.001, 0.001
    assert off._pick_steps(5) == off._pick_steps(0) == 16
    one = _server(tparams, chunk_steps=6)
    one._arrival_ema, one._step_wall_ema = 0.001, 0.001
    assert one._pick_steps(5) == 6


class _Clock:
    def __init__(self, *ticks):
        self.ticks = list(ticks)

    def __call__(self):
        return self.ticks.pop(0) if len(self.ticks) > 1 else self.ticks[0]


def test_arrival_gap_ema(tparams, monkeypatch):
    """0.8 * ema + 0.2 * gap over submit times 10.0, 11.0, 11.5, 13.5."""
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(),
                       max_new_tokens=2, continuous=True, n_slots=2,
                       max_prompt_tokens=16, device="cpu")
    try:
        srv = chat.server
        clock = _Clock(10.0, 11.0, 11.5, 13.5)
        monkeypatch.setattr(llms, "_PendingCompletion", _timed(clock))
        reqs = [srv.submit([1, 2, 3], 2)]
        assert srv._arrival_ema is None and srv._last_submit_t == 10.0
        reqs.append(srv.submit([1, 2, 3], 2))
        assert srv._arrival_ema == pytest.approx(1.0)
        reqs.append(srv.submit([1, 2, 3], 2))
        assert srv._arrival_ema == pytest.approx(0.8 * 1.0 + 0.2 * 0.5)
        reqs.append(srv.submit([1, 2, 3], 2))
        assert srv._arrival_ema == pytest.approx(0.8 * 0.9 + 0.2 * 2.0)
        for r in reqs:
            assert r.done.wait(60) and len(r.tokens) == 2
    finally:
        chat.close()


def _timed(clock):
    """``_PendingCompletion`` whose submit time comes from ``clock``."""
    base = llms._PendingCompletion

    def make(ids, max_new):
        req = base(ids, max_new)
        req.submitted_at = clock()
        return req

    return make


@pytest.mark.parametrize("spec", [True, False])
def test_step_wall_ema_per_dispatched_step(tparams, monkeypatch, spec):
    """0.7 * ema + 0.3 * per, per = tick-to-tick wall / the steps the last
    dispatch ran: cycles on a spec dispatch (16 // 4 = 4), steps on a
    plain one (16)."""
    srv = _server(tparams, spec_decode=spec)
    steps = 4 if spec else 16
    monkeypatch.setattr(llms.time, "perf_counter", _Clock(1.0, 3.0, 4.0, 4.0))
    active = np.array([True, False])
    assert srv._dispatch_decode(active)
    assert srv._step_wall_ema is None and srv._last_dispatch_steps == steps
    assert srv._dispatch_decode(active)
    assert srv._step_wall_ema == pytest.approx(2.0 / steps)
    assert srv._dispatch_decode(active)
    assert srv._step_wall_ema == pytest.approx(0.7 * 2.0 / steps + 0.3 * 1.0 / steps)
    assert srv.stats["spec_dispatches"] == (3 if spec else 0)
    assert srv.stats["decode_steps"] == 3 * steps


@pytest.fixture(scope="module")
def static_truth(jparams):
    tok = ToyCharTokenizer()
    return [np.asarray(JD.generate(
        jparams, jnp.asarray([tok.encode(p)], jnp.int32),
        jnp.ones((1, len(tok.encode(p))), jnp.int32), JCFG, NEW))[0].tolist()
        for p in PROMPTS]


@pytest.mark.parametrize("spec", [None, False])
@pytest.mark.parametrize("autotune", [None, False])
def test_staggered_burst_matches_static(tparams, static_truth, monkeypatch, spec,
                                        autotune):
    """A burst on 4 slots (a queue forms), then a later wave: tokens equal
    JAX static ``generate`` whether autotune (default on) moves the chunk
    boundaries or not, with spec decode at its default (on) or off."""
    sizes = []
    spec_fn, chunk_fn = TD.pool_decode_spec, TD.pool_decode_chunk

    def spec_rec(params, pool, active, cfg, n_cycles, **kw):
        sizes.append(("cycles", n_cycles))
        return spec_fn(params, pool, active, cfg, n_cycles, **kw)

    def chunk_rec(params, pool, active, gen, cfg, n_steps, **kw):
        sizes.append(("steps", n_steps))
        return chunk_fn(params, pool, active, gen, cfg, n_steps, **kw)

    monkeypatch.setattr(TD, "pool_decode_spec", spec_rec)
    monkeypatch.setattr(TD, "pool_decode_chunk", chunk_rec)
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(),
                       max_new_tokens=NEW, continuous=True, n_slots=4, chunk_steps=16,
                       pipeline_depth=2, max_prompt_tokens=32, spec_decode=spec,
                       chunk_autotune=autotune, device="cpu")
    try:
        srv = chat.server
        assert srv.chunk_autotune is (autotune is None)
        first = chat.submit_batch(PROMPTS[:6])
        assert first[0].done.wait(60)
        second = chat.submit_batch(PROMPTS[6:])  # a later wave
        for r in first + second:
            assert r.done.wait(60)
        texts = chat.resolve_batch([first + second])[0]
        assert [r.tokens for r in first + second] == static_truth
        assert texts == [ToyCharTokenizer().decode(t) for t in static_truth]
        kinds = {k for k, _ in sizes}
        assert kinds == ({"cycles"} if spec is None else {"steps"})
        got = {n for _, n in sizes}
        if autotune is None:
            # queue pressure picked the smallest candidate (4 steps = 1 cycle)
            assert min(got) == (1 if spec is None else 4)
        else:
            assert got == ({4} if spec is None else {16})
    finally:
        chat.close()
    assert not chat.server.thread.is_alive()
