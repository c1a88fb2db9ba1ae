"""The port's serving pools and continuous server against the JAX package.

Pool functions (``pool_admit``, ``pool_prefill_chunk``,
``pool_decode_chunk``) are held against the JAX ``pool_*`` functions on the
same pool state: dense and paged pools, bf16-free f32 configs with f32 and
int8 K/V, the paged decode through the gather path and through the kernel
path (JAX: the Pallas kernel in interpret mode; the port: its plain
version). Live KV and staged logits agree within 1e-5 (f32, other summation
order; int8 payloads are compared dequantized, within one quantization
step); greedy tokens are equal.

The continuous server (on the CPU) is held against JAX STATIC ``generate``
(the JAX continuous server is not the reference: on this tree it does not
always reproduce the static path): every request's greedy tokens equal the
static tokens of its prompt.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.utils import ToyCharTokenizer

JCFG = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=256, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=256, dtype=torch.float32)
N_SLOTS, CACHE_LEN, BLOCK = 4, 48, 8
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = ["hello world", "continuous batching at the chunk boundary", "abc",
           "qrs tuv wxyz and some more text to prefill in pieces", "x",
           "the quick brown fox"]


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return _port(jparams)


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _dequant(pool, name):
    x = np.asarray(pool[name], np.float32)
    sname = {"k": "k_scale", "v": "v_scale", "kb": "kb_scale", "vb": "vb_scale"}[name]
    if sname in pool:
        x = x * np.asarray(pool[sname], np.float32)
    return x


def _kv_close(tpool, jpool, names, live):
    """KV at live positions: dequantized, within one quantization step."""
    for name in names:
        got, want = _dequant(tpool, name), _dequant(jpool, name)
        atol = 1e-5
        sname = name + "_scale" if name in ("k", "v") else name + "_scale"
        if sname in jpool:
            atol = float(np.asarray(jpool[sname]).max()) * 1.01
        np.testing.assert_allclose(got[live(got)], want[live(got)], rtol=1e-5, atol=atol)


def _left(prompt_ids, s):
    ids = np.zeros((1, s), np.int32)
    mask = np.zeros((1, s), np.int32)
    ids[0, s - len(prompt_ids):] = prompt_ids
    mask[0, s - len(prompt_ids):] = 1
    return ids, mask


def _dense_live(tpool):
    sm = tpool["slot_mask"].numpy() > 0  # (S, C)
    return lambda x: np.broadcast_to(sm[None, :, None, :, None], x.shape)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_dense_pool_admit_chunk_decode_match_jax(jparams, tparams, flash, kv_quant):
    tok = ToyCharTokenizer(64)
    jpool = JD.pool_init(jparams, JCFG, N_SLOTS, CACHE_LEN, kv_quant=kv_quant)
    tpool = _port(jpool)
    # whole-prompt admissions: one into slot 2, a batch of two into 0 and 3
    ids, mask = _left(tok.encode(PROMPTS[0]), 16)
    jpool = JD.pool_admit(jparams, jnp.asarray(ids), jnp.asarray(mask), jpool,
                          jnp.int32(2), JCFG, flash=flash)
    tpool = TD.pool_admit(tparams, _t(ids), _t(mask), tpool, 2, TCFG, flash=flash)
    pair = (PROMPTS[2], PROMPTS[5])
    bi = np.concatenate([_left(tok.encode(p), 32)[0] for p in pair])
    bm = np.concatenate([_left(tok.encode(p), 32)[1] for p in pair])
    jpool = JD.pool_admit_batch(jparams, jnp.asarray(bi), jnp.asarray(bm), jpool,
                                jnp.asarray([0, 3], jnp.int32), JCFG, flash=flash)
    tpool = TD.pool_admit_batch(tparams, _t(bi), _t(bm), tpool, [0, 3], TCFG,
                                flash=flash)
    # a chunked admission into slot 1: a 32-wide left-padded prompt in
    # pieces of 8, the last stages the logits
    e = tok.encode(PROMPTS[1])[:27]
    ids, mask = _left(e, 32)
    pos = np.clip(np.cumsum(mask[0]) - 1, 0, None)[None].astype(np.int32)
    for o in range(0, 32, 8):
        args = (ids[:, o:o + 8], mask[:, o:o + 8], pos[:, o:o + 8])
        kw = dict(first=o == 0, last=o == 24, flash=flash)
        jpool = JD.pool_prefill_chunk(jparams, *map(jnp.asarray, args), jpool,
                                      jnp.int32(1), jnp.int32(o),
                                      jnp.asarray([len(e)], jnp.int32), JCFG, **kw)
        tpool = TD.pool_prefill_chunk(tparams, *map(_t, args), tpool, 1, o,
                                      len(e), TCFG, **kw)
    for name in ("slot_mask", "pos", "write"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    np.testing.assert_allclose(tpool["logits"].numpy(), np.asarray(jpool["logits"]), **TOL)
    _kv_close(tpool, jpool, ("k", "v"), _dense_live(tpool))
    # a decode chunk with slot 3 idle
    active = np.array([True, True, True, False])
    jpool, jt = JD.pool_decode_chunk(jparams, jpool, jnp.asarray(active),
                                     jax.random.PRNGKey(0), JCFG, 5)
    tpool, tt = TD.pool_decode_chunk(tparams, tpool, active, None, TCFG, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in ("slot_mask", "pos", "write"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    np.testing.assert_allclose(tpool["logits"].numpy(), np.asarray(jpool["logits"]),
                               rtol=1e-4, atol=1e-4 if kv_quant else 1e-5)
    _kv_close(tpool, jpool, ("k", "v"), _dense_live(tpool))


def _paged_pools(jparams, kv_quant):
    n_blocks = N_SLOTS * (CACHE_LEN // BLOCK) + 1
    jpool = JD.paged_pool_init(jparams, JCFG, N_SLOTS, CACHE_LEN, n_blocks,
                               BLOCK, kv_quant=kv_quant)
    tpool = _port(jpool)
    # shuffled physical blocks; slot 2 gets only 3 blocks (sentinel tail)
    rng = np.random.default_rng(0)
    ids = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    M = CACHE_LEN // BLOCK
    for s in range(N_SLOTS):
        row = ids[s * M:(s + 1) * M].copy()
        if s == 2:
            row[3:] = 0
        jpool = JD.paged_table_set(jpool, jnp.int32(s), jnp.asarray(row))
        tpool = TD.paged_table_set(tpool, s, row)
    return jpool, tpool


def _paged_live(tpool, block):
    """Live positions of the block planes: (block, column) pairs that a
    live logical column of some slot maps to."""
    tbl = tpool["block_tbl"].numpy()
    sm = tpool["slot_mask"].numpy()
    live = np.zeros(tpool["kb"].shape[1:2] + (block,), bool)
    for s in range(tbl.shape[0]):
        for c in np.nonzero(sm[s])[0]:
            live[tbl[s, c // block], c % block] = True
    return lambda x: np.broadcast_to(live[None, :, None, :, None], x.shape)


@pytest.mark.parametrize("paged_kernel", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_pool_prefill_and_decode_match_jax(jparams, tparams, paged_kernel, kv_quant):
    """Right-padded piecewise admission (as the paged server does), then a
    decode chunk through the gather path or the kernel path. The sentinel
    block stays zero throughout."""
    tok = ToyCharTokenizer(64)
    jpool, tpool = _paged_pools(jparams, kv_quant)
    for slot, prompt, flash in ((0, PROMPTS[1], True), (2, PROMPTS[0], False),
                                (3, PROMPTS[3], True)):
        e = tok.encode(prompt)[:20]
        n = len(e)
        W = -(-n // 8) * 8
        ids = np.zeros((1, W), np.int32)
        mask = np.zeros((1, W), np.int32)
        ids[0, :n], mask[0, :n] = e, 1
        pos = np.minimum(np.arange(W), n - 1)[None].astype(np.int32)
        for o in range(0, W, 8):
            last = o + 8 >= W
            lc = (n - 1) - (W - 8)
            lc = None if (not last or lc == 7) else lc
            args = (ids[:, o:o + 8], mask[:, o:o + 8], pos[:, o:o + 8])
            kw = dict(first=o == 0, last=last, flash=flash)
            jpool = JD.pool_prefill_chunk(
                jparams, *map(jnp.asarray, args), jpool, jnp.int32(slot),
                jnp.int32(o), jnp.asarray([n], jnp.int32), JCFG,
                last_col=None if lc is None else jnp.int32(lc), **kw)
            tpool = TD.pool_prefill_chunk(tparams, *map(_t, args), tpool, slot,
                                          o, n, TCFG, last_col=lc, **kw)
    live = _paged_live(tpool, BLOCK)
    np.testing.assert_allclose(tpool["logits"].numpy(), np.asarray(jpool["logits"]), **TOL)
    _kv_close(tpool, jpool, ("kb", "vb"), live)
    active = np.array([True, False, True, True])
    jpool, jt = JD.pool_decode_chunk(jparams, jpool, jnp.asarray(active),
                                     jax.random.PRNGKey(0), JCFG, 6,
                                     paged_kernel=paged_kernel)
    tpool, tt = TD.pool_decode_chunk(tparams, tpool, active, None, TCFG, 6,
                                     paged_kernel=paged_kernel)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in ("slot_mask", "pos", "write", "block_tbl"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    np.testing.assert_allclose(tpool["logits"].numpy(), np.asarray(jpool["logits"]),
                               rtol=1e-4, atol=1e-4 if kv_quant else 1e-5)
    _kv_close(tpool, jpool, ("kb", "vb"), _paged_live(tpool, BLOCK))
    for name in ("kb", "vb", "kb_scale", "vb_scale"):
        if name in tpool:
            assert torch.all(tpool[name][:, 0] == 0), f"sentinel block of {name} written"


def test_paged_pool_admit_gather_scatter(jparams, tparams):
    """Whole-prompt admission into a paged pool (gather, run, scatter)
    equals JAX and leaves the sentinel zero."""
    tok = ToyCharTokenizer(64)
    jpool, tpool = _paged_pools(jparams, False)
    ids, mask = _left(tok.encode(PROMPTS[5]), 32)
    jpool = JD.pool_admit(jparams, jnp.asarray(ids), jnp.asarray(mask), jpool,
                          jnp.int32(1), JCFG)
    tpool = TD.pool_admit(tparams, _t(ids), _t(mask), tpool, 1, TCFG)
    np.testing.assert_allclose(tpool["logits"].numpy(), np.asarray(jpool["logits"]), **TOL)
    _kv_close(tpool, jpool, ("kb", "vb"), _paged_live(tpool, BLOCK))
    assert torch.all(tpool["kb"][:, 0] == 0)


def test_block_allocator_semantics():
    a = TD.BlockAllocator(6)
    assert a.alloc(3) == [1, 2, 3]
    before = a.stats()
    with pytest.raises(TD.PagedPoolOOM) as ei:
        a.alloc(3)
    assert ei.value.want == 3 and ei.value.free == 2 and a.stats() == before
    a.pin([2])
    assert a.release([2]) == 0 and a.release([2]) == 1
    assert a.alloc(1) == [2]
    with pytest.raises(ValueError):
        a.release([5])
    with pytest.raises(ValueError):
        TD.BlockAllocator(1)


@pytest.fixture(scope="module")
def static_tokens(jparams):
    """JAX static greedy tokens of every prompt, f32 and int8 weights."""
    tok = ToyCharTokenizer(64)
    out = {}
    for quant in (False, True):
        p = JD.quantize_params(jparams, JCFG) if quant else jparams
        out[quant] = [np.asarray(JD.generate(
            p, jnp.asarray([tok.encode(s)], jnp.int32),
            jnp.ones((1, len(tok.encode(s))), jnp.int32), JCFG, 8))[0]
            for s in PROMPTS]
    return out


SERVER_CASES = {
    "dense": dict(),
    "dense-flash-int8kv": dict(flash_prefill=True, kv_quant="int8"),
    "dense-unchunked": dict(chunked_prefill=False, flash_prefill=True),
    "paged-gather": dict(paged_kv=True, paged_kv_block=8),
    "paged-kernel-flash": dict(paged_kv=True, paged_kv_block=8, paged_kernel=True,
                               flash_prefill=True),
    "paged-kernel-int8kv-int8w": dict(paged_kv=True, paged_kv_block=8,
                                      paged_kernel=True, flash_prefill=True,
                                      kv_quant="int8", weight_quant="int8",
                                      wq_kernel=True),
}


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_continuous_server_matches_jax_static_generate(tparams, static_tokens, case):
    kw = SERVER_CASES[case]
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(64),
                       max_new_tokens=8, continuous=True, n_slots=3,
                       chunk_steps=4, pipeline_depth=2, prefill_chunk=8,
                       max_prompt_tokens=64, device="cpu", **kw)
    try:
        srv = chat.server
        reqs = [srv.submit(ToyCharTokenizer(64).encode(p), 8) for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(60)
        want = static_tokens[bool(kw.get("weight_quant"))]
        for r, w in zip(reqs, want):
            assert r.tokens == w.tolist()
        assert srv.failed is None and srv.stats["admitted"] == len(PROMPTS)
        if srv.paged_kv:
            assert srv.stats["prefill_chunks"] >= len(PROMPTS)
            for name in ("kb", "vb"):
                assert torch.all(srv.pool[name][:, 0] == 0)
            # every block returned but those the prefix tree (on by
            # default) still pins
            assert srv._allocator.n_allocated == srv.prefix.used_blocks
        texts = chat([PROMPTS[0], PROMPTS[2]])
        assert texts == [ToyCharTokenizer(64).decode(want[i].tolist()) for i in (0, 2)]
    finally:
        chat.close()
    assert not chat.server.thread.is_alive()


def test_static_chat_matches_jax_chat(jparams, tparams):
    from pathway_tpu.xpacks.llm.llms import TPUDecoderChat

    tok = ToyCharTokenizer(64)
    msgs = ["hi", "hello world", [{"role": "user", "content": "abc"}]]
    want = TPUDecoderChat(params=jparams, cfg=JCFG, tokenizer=tok,
                          max_new_tokens=6).__wrapped__(msgs)
    got = DecoderChat(params=tparams, cfg=TCFG, tokenizer=tok, max_new_tokens=6,
                      device="cpu")(msgs)
    assert got == want
