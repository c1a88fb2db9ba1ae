"""Self-speculative decode in the port against the JAX package.

Pool level: ``pool_decode_spec`` and ``pool_decode_draft`` are held against
the JAX functions on the same admitted pool (``pool_admit_batch`` on both
sides): tokens and emit counts equal, staged logits and live K/V within
1e-5 (int8 K/V dequantized, within one quantization step), over f32, int8
K/V, a paged pool with a block two table rows share, and int8 weights
through the ``wq_matmul`` seam (its plain version on the CPU). Then the
port against itself: spec streams equal plain greedy ``pool_decode_chunk``,
a full-depth draft accepts everything, inactive lanes stay frozen, the
draft is pure, and drafting in place ends in the same pool as drafting on
copies.

Serving level: spec decode is on by default; every stream equals JAX
STATIC ``generate`` (never the JAX continuous server, whose spec serving
tests fail intermittently on this tree) and the port's ``spec_decode=False``
arm, across prefix cache x chunked prefill x dense / paged-kernel pools.
Gating, the draft-depth rule, the acceptance latch, the spec slack and the
``engine/probes`` spec ledger close the file. Every wait is bounded.

The weights are JAX's seeded init with the layer weights scaled by 10, so
the deeper layers move the argmax and drafts are sometimes rejected (at
the init scale every draft of this tiny model is accepted)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.engine import probes
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.utils import ToyCharTokenizer

_DIMS = dict(vocab_size=128, hidden=32, layers=4, heads=4, intermediate=64,
             max_position=128)
JCFG = JD.DecoderConfig(**_DIMS, dtype=jnp.float32)
TCFG = TD.DecoderConfig(**_DIMS, dtype=torch.float32)
N_SLOTS, CACHE_LEN, BLOCK, NEW = 4, 96, 8, 16
ACTIVE = np.array([True, False, True, True])
SPEC_CASES = [(1, 3), (2, 2), (3, 4)]


@pytest.fixture(scope="module")
def jparams():
    p = JD.init_params(jax.random.PRNGKey(0), JCFG)
    layers = {k: v * 10.0 if k.endswith("_w") else v for k, v in p["layers"].items()}
    return {**p, "layers": layers}


@pytest.fixture(scope="module")
def tparams(jparams):
    return _port(jparams)


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


def _prompts():
    """Four seeded prompts of 13, 9, 11 and 7 tokens; the first and the
    third share their first 8 tokens (one paged block)."""
    rng = np.random.default_rng(0)
    out = [rng.integers(1, 97, n).astype(np.int32) for n in (13, 9, 11, 7)]
    out[2][:BLOCK] = out[0][:BLOCK]
    return out


def _left_padded():
    S = 16
    ids = np.zeros((N_SLOTS, S), np.int32)
    mask = np.zeros((N_SLOTS, S), np.int32)
    for r, e in enumerate(_prompts()):
        ids[r, S - len(e):] = e
        mask[r, S - len(e):] = 1
    return ids, mask


def _port_pool(tp, kv_quant=False, cfg=TCFG):
    """The four prompts left-padded to 16, admitted by one
    ``pool_admit_batch`` into a dense pool of the port."""
    ids, mask = _left_padded()
    tpool = TD.pool_init(tp, cfg, N_SLOTS, CACHE_LEN, kv_quant=kv_quant)
    return TD.pool_admit_batch(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                               tpool, list(range(N_SLOTS)), cfg)


def _dense_pools(jp, tp, kv_quant=False, tcfg=TCFG):
    """:func:`_port_pool` and the same admission on the JAX side."""
    ids, mask = _left_padded()
    jpool = JD.pool_init(jp, JCFG, N_SLOTS, CACHE_LEN, kv_quant=kv_quant)
    jpool = JD.pool_admit_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jpool,
                                jnp.arange(N_SLOTS, dtype=jnp.int32), JCFG)
    return jpool, _port_pool(tp, kv_quant, tcfg)


def _paged_pools(jp, tp):
    """The four prompts right-padded into a paged pool in pieces of 8, as
    the paged server admits them; then slot 2's first table entry points
    at slot 0's first block, which holds the same 8 tokens' K/V: a block
    two rows share."""
    M = CACHE_LEN // BLOCK
    n_blocks = N_SLOTS * M + 1
    jpool = JD.paged_pool_init(jp, JCFG, N_SLOTS, CACHE_LEN, n_blocks, BLOCK)
    tpool = _port(jpool)
    for s, e in enumerate(_prompts()):
        row = np.arange(1, M + 1, dtype=np.int32) + s * M
        jpool = JD.paged_table_set(jpool, jnp.int32(s), jnp.asarray(row))
        tpool = TD.paged_table_set(tpool, s, row)
        n = len(e)
        W = -(-n // BLOCK) * BLOCK
        ids = np.zeros((1, W), np.int32)
        mask = np.zeros((1, W), np.int32)
        ids[0, :n], mask[0, :n] = e, 1
        pos = np.minimum(np.arange(W), n - 1)[None].astype(np.int32)
        for o in range(0, W, BLOCK):
            last = o + BLOCK >= W
            lc = (n - 1) - (W - BLOCK) if last else None
            args = (ids[:, o:o + BLOCK], mask[:, o:o + BLOCK], pos[:, o:o + BLOCK])
            kw = dict(first=o == 0, last=last)
            jpool = JD.pool_prefill_chunk(
                jp, *map(jnp.asarray, args), jpool, jnp.int32(s), jnp.int32(o),
                jnp.asarray([n], jnp.int32), JCFG,
                last_col=None if lc is None else jnp.int32(lc), **kw)
            tpool = TD.pool_prefill_chunk(tp, *map(torch.from_numpy, args), tpool,
                                          s, o, n, TCFG, last_col=lc, **kw)
    shared = int(tpool["block_tbl"][0, 0])
    row2 = tpool["block_tbl"][2].numpy().copy()
    np.testing.assert_array_equal(tpool["kb"][:, shared].numpy(),
                                  tpool["kb"][:, row2[0]].numpy())
    row2[0] = shared
    jpool = JD.paged_table_set(jpool, jnp.int32(2), jnp.asarray(row2))
    tpool = TD.paged_table_set(tpool, 2, row2)
    return jpool, tpool, shared


def _dequant(pool, name):
    x = np.asarray(pool[name], np.float32)
    if name + "_scale" in pool:
        x = x * np.asarray(pool[name + "_scale"], np.float32)
    return x


def _kv_close(tpool, jpool, names, live):
    """Live K/V dequantized, within 1e-5 (one quantization step for int8)."""
    for name in names:
        atol = 1e-5
        if name + "_scale" in jpool:
            atol = float(np.asarray(jpool[name + "_scale"]).max()) * 1.01
        got, want = _dequant(tpool, name), _dequant(jpool, name)
        mask = live(got)
        np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5, atol=atol)


def _dense_live(tpool):
    sm = tpool["slot_mask"].numpy() > 0
    return lambda x: np.broadcast_to(sm[None, :, None, :, None], x.shape)


def _paged_live(tpool):
    tbl, sm = tpool["block_tbl"].numpy(), tpool["slot_mask"].numpy()
    live = np.zeros((tpool["kb"].shape[1], BLOCK), bool)
    for s in range(tbl.shape[0]):
        for c in np.nonzero(sm[s])[0]:
            live[tbl[s, c // BLOCK], c % BLOCK] = True
    return lambda x: np.broadcast_to(live[None, :, None, :, None], x.shape)


def _streams(toks, n_emit):
    toks, n_emit = np.asarray(toks), np.asarray(n_emit)
    return [[int(t) for c in range(toks.shape[0]) for t in toks[c, b, :n_emit[c, b]]]
            for b in range(toks.shape[1])]


# -- (a) pool level, against JAX ---------------------------------------------


@pytest.mark.parametrize("variant", ["f32", "int8kv", "paged", "int8w"])
@pytest.mark.parametrize("draft_layers,k", SPEC_CASES)
def test_pool_decode_spec_matches_jax(jparams, tparams, variant, draft_layers, k):
    jp, tp, tcfg = jparams, tparams, TCFG
    if variant == "int8w":
        jp = JD.quantize_params(jparams, JCFG)
        tcfg = TD.DecoderConfig(**_DIMS, dtype=torch.float32, wq_kernel=True)
        tp = TD.quantize_params(tparams, tcfg)
    if variant == "paged":
        jpool, tpool, shared = _paged_pools(jp, tp)
        before = {n: tpool[n][:, shared].clone() for n in ("kb", "vb")}
        jbefore = {n: np.asarray(jpool[n])[:, shared] for n in ("kb", "vb")}
    else:
        jpool, tpool = _dense_pools(jp, tp, kv_quant=variant == "int8kv", tcfg=tcfg)
    n_cycles = 5
    jpool, jt, je = JD.pool_decode_spec(jp, jpool, jnp.asarray(ACTIVE), JCFG, n_cycles,
                                        draft_layers=draft_layers, n_spec=k)
    tpool, tt, te = TD.pool_decode_spec(tp, tpool, ACTIVE, tcfg, n_cycles,
                                        draft_layers=draft_layers, n_spec=k)
    assert tt.shape == (n_cycles, N_SLOTS, k + 1) and tt.dtype == torch.int32
    assert te.shape == (n_cycles, N_SLOTS) and te.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for name in ("slot_mask", "pos", "write"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    np.testing.assert_allclose(tpool["logits"].numpy(), np.asarray(jpool["logits"]),
                               rtol=1e-5, atol=1e-5)
    if variant == "paged":
        _kv_close(tpool, jpool, ("kb", "vb"), _paged_live(tpool))
        for n in ("kb", "vb"):
            assert torch.equal(tpool[n][:, shared], before[n]), f"shared block of {n} written"
            np.testing.assert_array_equal(np.asarray(jpool[n])[:, shared], jbefore[n])
            assert torch.all(tpool[n][:, 0] == 0), f"sentinel block of {n} written"
    else:
        _kv_close(tpool, jpool, ("k", "v"), _dense_live(tpool))
    assert te.numpy()[:, ~ACTIVE].sum() == 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_pool_decode_draft_matches_jax_and_is_pure(jparams, tparams, kv_quant):
    jpool, tpool = _dense_pools(jparams, tparams, kv_quant)
    before = _clone(tpool)
    want = JD.pool_decode_draft(jparams, jpool, jnp.asarray(ACTIVE), JCFG,
                                draft_layers=2, n_draft=3)
    got = TD.pool_decode_draft(tparams, tpool, ACTIVE, TCFG, draft_layers=2, n_draft=3)
    assert got.shape == (N_SLOTS, 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert before.keys() == tpool.keys()
    for name, t in before.items():
        assert torch.equal(tpool[name], t), f"pool_decode_draft changed {name}"


def test_paged_pool_decode_draft_matches_jax(jparams, tparams):
    jpool, tpool, _ = _paged_pools(jparams, tparams)
    before = _clone(tpool)
    want = JD.pool_decode_draft(jparams, jpool, jnp.asarray(ACTIVE), JCFG,
                                draft_layers=3, n_draft=4)
    got = TD.pool_decode_draft(tparams, tpool, ACTIVE, TCFG, draft_layers=3, n_draft=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name, t in before.items():
        assert torch.equal(tpool[name], t), f"pool_decode_draft changed {name}"


# -- (b) the port against itself ---------------------------------------------


@pytest.mark.parametrize("draft_layers,k", SPEC_CASES)
def test_spec_streams_equal_plain_greedy(tparams, draft_layers, k):
    """Acceptance changes how fast tokens come, never which."""
    pool = _port_pool(tparams)
    _, plain = TD.pool_decode_chunk(tparams, _clone(pool), np.ones(N_SLOTS, bool),
                                    None, TCFG, NEW)
    _, toks, n_emit = TD.pool_decode_spec(tparams, pool, np.ones(N_SLOTS, bool), TCFG,
                                          NEW, draft_layers=draft_layers, n_spec=k)
    for b, seq in enumerate(_streams(toks, n_emit)):
        assert seq[:NEW] == plain[:, b].tolist(), (draft_layers, k, b)
    ne = n_emit.numpy()
    assert ne.min() >= 1 and (ne < k + 1).any(), "no draft was rejected"


def test_full_depth_draft_accepts_everything(tparams):
    pool = _port_pool(tparams)
    k = 3
    _, _, n_emit = TD.pool_decode_spec(tparams, pool, np.ones(N_SLOTS, bool), TCFG, 4,
                                       draft_layers=TCFG.layers, n_spec=k)
    assert n_emit.min().item() == k + 1


def test_spec_inactive_lanes_frozen(tparams):
    """Inactive lanes emit 0 and keep their logits, cursors, mask and K/V
    bitwise."""
    for kv_quant in (False, True):
        pool = _port_pool(tparams, kv_quant)
        before = _clone(pool)
        pool, _, n_emit = TD.pool_decode_spec(tparams, pool, ACTIVE, TCFG, 4,
                                              draft_layers=2, n_spec=3)
        idle = np.nonzero(~ACTIVE)[0]
        assert n_emit.numpy()[:, idle].sum() == 0
        assert (n_emit.numpy()[:, ACTIVE] >= 1).all()
        for name in ("logits", "slot_mask", "pos", "write"):
            assert torch.equal(pool[name][idle], before[name][idle]), name
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in pool:
                assert torch.equal(pool[name][:, idle], before[name][:, idle]), name


@pytest.mark.parametrize("kv_quant", [False, True])
def test_in_place_draft_equals_draft_on_copies(tparams, monkeypatch, kv_quant):
    """``pool_decode_spec`` drafts into the pool's own depth-prefix planes;
    the final pool is byte-equal to the one a draft on copies leaves."""
    pool = _port_pool(tparams, kv_quant)
    pool["write"][0] = CACHE_LEN - 2  # a lane at the clamp
    act = np.ones(N_SLOTS, bool)
    act[1] = False
    in_place, t1, e1 = TD.pool_decode_spec(tparams, _clone(pool), act, TCFG, 6,
                                           draft_layers=2, n_spec=3)
    orig = TD._draft_scan

    def on_copies(params, cfg, planes, *a):
        return orig(params, cfg, {n: p.clone() for n, p in planes.items()}, *a)

    monkeypatch.setattr(TD, "_draft_scan", on_copies)
    copies, t2, e2 = TD.pool_decode_spec(tparams, _clone(pool), act, TCFG, 6,
                                         draft_layers=2, n_spec=3)
    assert torch.equal(t1, t2) and torch.equal(e1, e2)
    for name, t in copies.items():
        assert torch.equal(in_place[name], t), name


def test_pool_bytes_matches_jax(jparams, tparams):
    for kv_quant in (False, True):
        jpool = JD.pool_init(jparams, JCFG, N_SLOTS, CACHE_LEN, kv_quant=kv_quant,
                             arena_blocks=3, arena_block=BLOCK)
        assert TD.pool_bytes(_port(jpool)) == JD.pool_bytes(jpool)
        jpool = JD.paged_pool_init(jparams, JCFG, N_SLOTS, CACHE_LEN, 9, BLOCK,
                                   kv_quant=kv_quant)
        assert TD.pool_bytes(_port(jpool)) == JD.pool_bytes(jpool)


# -- (c) serving ---------------------------------------------------------------

HEAD = "the shared head of every prompt "  # 32 tokens: four blocks of 8
SERVE_PROMPTS = [HEAD + s for s in ("q01", "hello world", "abc", "qrs tuv wxyz")] + [
    "zzz", "continuous batching"]
SERVE_NEW = 10


@pytest.fixture(scope="module")
def static_tokens(jparams):
    """JAX static greedy tokens of every serving prompt."""
    tok = ToyCharTokenizer(96)
    return [np.asarray(JD.generate(
        jparams, jnp.asarray([tok.encode(s)], jnp.int32),
        jnp.ones((1, len(tok.encode(s))), jnp.int32), JCFG, SERVE_NEW))[0].tolist()
        for s in SERVE_PROMPTS]


def _serve(tparams, prompts=SERVE_PROMPTS, **kw):
    """The first prompt alone (so its head is cached), then the rest at
    once; returns the token streams and the server."""
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(96),
                       max_new_tokens=SERVE_NEW, continuous=True, n_slots=3,
                       chunk_steps=4, pipeline_depth=2, prefill_chunk=8,
                       max_prompt_tokens=64, device="cpu", **kw)
    try:
        srv = chat.server
        tok = ToyCharTokenizer(96)
        first = srv.submit(tok.encode(prompts[0]), SERVE_NEW)
        assert first.done.wait(60)
        reqs = [first] + [srv.submit(tok.encode(p), SERVE_NEW) for p in prompts[1:]]
        for r in reqs:
            assert r.done.wait(60)
        assert srv.failed is None
        return [r.tokens for r in reqs], srv
    finally:
        chat.close()
        assert not chat.server.thread.is_alive()


POOLS = {"dense": dict(), "paged-kernel": dict(paged_kv=True, paged_kv_block=8,
                                               paged_kernel=True)}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("chunked_prefill", [False, True])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_serving_spec_default_matches_static_and_spec_off(
        tparams, static_tokens, pool, chunked_prefill, prefix_cache):
    kw = dict(POOLS[pool], chunked_prefill=chunked_prefill, prefix_cache=prefix_cache)
    spec, srv = _serve(tparams, **kw)
    assert srv.spec_decode and srv.spec_draft_layers == 1 and srv.spec_k == 3
    assert srv.stats["spec_dispatches"] > 0
    if prefix_cache and chunked_prefill:
        assert srv.stats["prefix_hit_requests"] > 0
    assert spec == static_tokens
    plain, srv_off = _serve(tparams, spec_decode=False, **kw)
    assert srv_off.stats["spec_dispatches"] == 0
    assert plain == spec


# -- (d) gating, slack, latch, ledger ------------------------------------------


def _server(tparams, cfg=TCFG, **kw):
    chat = DecoderChat(params=tparams, cfg=cfg, tokenizer=ToyCharTokenizer(96),
                       max_new_tokens=4, continuous=True, n_slots=2,
                       max_prompt_tokens=16, device="cpu", **kw)
    chat.close()
    return chat.server


@pytest.mark.parametrize("sampling", [dict(temperature=0.8), dict(top_k=5),
                                      dict(top_p=0.9)])
def test_sampling_server_has_spec_off(tparams, sampling):
    srv = _server(tparams, spec_decode=True, **sampling)
    assert srv.spec_decode is False
    assert srv._slack == srv.chunk_steps


def test_draft_layer_rule_and_clamps(tparams):
    srv = _server(tparams)  # defaults: on, auto depth layers // 4, k 3
    assert (srv.spec_decode, srv.spec_draft_layers, srv.spec_k) == (True, 1, 3)
    assert srv._slack == max(srv.chunk_steps, 4)
    assert _server(tparams, spec_draft_layers=0).spec_draft_layers == 1
    assert _server(tparams, spec_draft_layers=-2).spec_draft_layers == 1
    assert _server(tparams, spec_draft_layers=2).spec_draft_layers == 2
    assert _server(tparams, spec_draft_layers=9).spec_draft_layers == 3  # layers - 1
    assert _server(tparams, spec_k=0).spec_k == 1
    assert _server(tparams, spec_k=5).spec_k == 5
    # GPT-2 small's depth: 12 layers draft with 3
    cfg12 = TD.DecoderConfig(vocab_size=128, hidden=16, layers=12, heads=2,
                             intermediate=32, max_position=128, dtype=torch.float32)
    p12 = TD.init_params(torch.Generator().manual_seed(0), cfg12)
    assert _server(p12, cfg=cfg12).spec_draft_layers == 3
    # one layer has no shallower draft stack
    cfg1 = TD.DecoderConfig(**{**_DIMS, "layers": 1}, dtype=torch.float32)
    p1 = TD.init_params(torch.Generator().manual_seed(0), cfg1)
    assert _server(p1, cfg=cfg1, spec_decode=True).spec_decode is False
    assert _server(tparams, spec_decode=False).spec_decode is False


def test_acceptance_latch_turns_spec_off(tparams, static_tokens, monkeypatch):
    """The drain accounting fed a synthetic acceptance of 0 (every lane
    emits 1 a cycle): the fourth drain trips the latch, every dispatch
    after it is plain, and the streams are unchanged."""
    from pathway_tpu_torch.xpacks.llm import llms

    events = []
    spec_fn, chunk_fn = TD.pool_decode_spec, TD.pool_decode_chunk

    def spec(*a, **k):
        events.append("spec")
        return spec_fn(*a, **k)

    def chunk(*a, **k):
        events.append("plain")
        return chunk_fn(*a, **k)

    account = llms._ContinuousServer._spec_account

    def synthetic(self, emit, lanes):
        account(self, np.ones_like(emit), lanes)
        events.append(f"drain:{self._spec_off}")

    monkeypatch.setattr(TD, "pool_decode_spec", spec)
    monkeypatch.setattr(TD, "pool_decode_chunk", chunk)
    monkeypatch.setattr(llms._ContinuousServer, "_spec_account", synthetic)
    streams, srv = _serve(tparams)
    assert streams == static_tokens
    assert srv._spec_off and srv.spec_latched_at == 4
    assert srv.spec_acceptance() == 0.0
    latch = events.index("drain:True")
    assert events[:latch].count("drain:False") == 3
    after = [e for e in events[latch:] if not e.startswith("drain")]
    assert after and set(after) == {"plain"}
    assert srv.stats["spec_dispatches"] == events.count("spec") >= 4


@pytest.fixture(scope="module")
def slack_case(jparams):
    """Prompts for the slack test (the first fills its 32-token bucket) and
    their JAX static tokens."""
    tok = ToyCharTokenizer(96)
    prompts = ["abcdefgh" * 4, "hello", "qrs tuv wxyz 0123", "p"]
    want = [np.asarray(JD.generate(jparams, jnp.asarray([tok.encode(p)], jnp.int32),
                                   jnp.ones((1, len(tok.encode(p))), jnp.int32), JCFG,
                                   SLACK_NEW))[0].tolist() for p in prompts]
    return prompts, want


SLACK_NEW = 14  # 32 + 14 + 2 = 48: a whole number of paged blocks, no rounding slack


@pytest.mark.parametrize("paged,spec_k", [(True, 3), (False, 5)])
def test_spec_slack_covers_verify_columns(tparams, slack_case, paged, spec_k):
    """chunk_steps 2 < spec_k + 1: the cache slack widens to spec_k + 1
    columns a dispatch, so a lane near its budget never clamps its verify
    window (``C - 1 - spec_k``) onto earlier columns, which a slack of 2
    (cache_len 48) would do at spec_k 5; a paged lane's allocation covers
    every column it decodes into, and the sentinel stays zero. Every lane
    runs to its budget with the spec-off streams and JAX static
    ``generate``'s."""
    prompts, want = slack_case
    tok = ToyCharTokenizer(96)
    kw = dict(pipeline_depth=0, spec_k=spec_k)
    if paged:
        kw.update(paged_kv=True, paged_kv_block=8, paged_kernel=True)
    out = {}
    for spec in (True, False):
        chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=tok,
                           max_new_tokens=SLACK_NEW, continuous=True, n_slots=2,
                           chunk_steps=2, prefill_chunk=8, max_prompt_tokens=32,
                           spec_decode=spec, device="cpu", **kw)
        try:
            srv = chat.server
            slack = spec_k + 1 if spec else 2
            assert srv._slack == slack
            assert srv.cache_len == -(-(32 + SLACK_NEW + slack) // 8) * 8 if paged else (
                32 + SLACK_NEW + slack)
            reqs = [srv.submit(tok.encode(p), SLACK_NEW) for p in prompts]
            for r in reqs:
                assert r.done.wait(60)
            assert all(len(r.tokens) == SLACK_NEW for r in reqs)
            if paged:
                for name in ("kb", "vb"):
                    assert torch.all(srv.pool[name][:, 0] == 0), f"sentinel of {name} written"
            out[spec] = ([r.tokens for r in reqs], dict(srv.stats))
        finally:
            chat.close()
    assert out[True][1]["spec_dispatches"] > 0
    assert out[True][0] == out[False][0] == want


def test_spec_ledger_agrees_with_server(tparams):
    """Once the loop has drained every dispatch and gone idle (where it
    flushes), the ``engine/probes`` spec ledger equals the server's
    counters; an int8-KV pool records its saved bytes once."""
    probes.reset_spec_stats()
    tok = ToyCharTokenizer(96)
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=tok, max_new_tokens=SERVE_NEW,
                       continuous=True, n_slots=3, chunk_steps=4, pipeline_depth=2,
                       prefill_chunk=8, max_prompt_tokens=64, kv_quant="int8",
                       device="cpu")
    try:
        srv = chat.server
        reqs = [srv.submit(tok.encode(p), SERVE_NEW) for p in SERVE_PROMPTS]
        for r in reqs:
            assert r.done.wait(60)
        end = time.monotonic() + 30.0
        while time.monotonic() < end:
            if (not srv._inflight and probes.spec_stats()["counts"].get("dispatches")
                    == srv.stats["spec_dispatches"]):
                break
            time.sleep(0.01)
        led, st = probes.spec_stats(), dict(srv.stats)
    finally:
        chat.close()
    c = led["counts"]
    assert c["dispatches"] == st["spec_dispatches"] > 0
    for name in ("verify_steps", "drafted", "accepted", "emitted"):
        assert c[name] == st["spec_" + name], name
    assert c["draft_steps"] == c["drafted"]
    assert led["acceptance_rate"] == round(srv.spec_acceptance(), 4)
    assert led["tokens_per_dispatch"] == round(srv.tokens_per_dispatch(), 4)
    assert 0.0 <= led["acceptance_rate"] <= 1.0 and led["tokens_per_dispatch"] >= 1.0
    assert led["kv_bytes_saved"] == srv.kv_bytes_saved > 0
    # against the same pool's planes in f32 (4 bytes a value)
    base = sum(srv.pool[n].numel() * 4 for n in ("k", "v", "arena_k", "arena_v"))
    assert srv.kv_bytes_saved == base - TD.pool_bytes(srv.pool)
    probes.reset_spec_stats()
    assert probes.spec_stats() == {"counts": {}, "acceptance_rate": 0.0,
                                   "tokens_per_dispatch": 0.0, "kv_bytes_saved": 0}
