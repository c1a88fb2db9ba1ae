"""The port's prefix KV cache against the JAX package.

- The radix tree and the host tier (``engine/prefix_cache.py``): each case
  of ``tests/test_prefix_cache.py`` runs as one op sequence through the JAX
  ``PrefixCache`` / ``HostTierStore`` and the port's copy, with each side's
  probe ledger reset first; returns, stats and ledgers must be equal.
- The pool functions that move cached KV (``kv_extract``, ``kv_insert``,
  ``pool_admit_cached``, ``paged_admit_cached``, ``kv_block_export``,
  ``kv_block_import``) on the same seeded pool state, bf16 and int8 KV:
  every plane equal bit for bit (they only move data).
- Serving on the dense and the paged pool: the cache off, sequential hits
  at every suffix split, a burst, the byte budget's LRU and the tier-2
  round trip, each held against JAX static ``generate`` (greedy; the JAX
  continuous server is not the reference, ROADMAP C) and the tier-2 trace
  also against the port's own single-tier arm.
- Two slots sharing a cached head, decoded through the gather-run-scatter
  route, against JAX: the shared blocks keep their bytes.

Every wait is bounded, so a lost request fails instead of hanging.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine import prefix_cache as JPC
from pathway_tpu.engine import probes as JP
from pathway_tpu.models import decoder as JD
from pathway_tpu_torch.engine import prefix_cache as TPC
from pathway_tpu_torch.engine import probes as TP
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.utils import ToyCharTokenizer

B = 8  # tree block = prefill piece in the unit cases and the servers


# -- radix tree and host tier ------------------------------------------------


def _toks(*blocks):
    out = []
    for b in blocks:
        out.extend([b] * B)
    return out


def _K(v):
    return tuple([v] * B)


def _blob(vals):
    return {"k": np.asarray([[v, v + 0.5] for v in vals], np.float32)}


def _path(node):
    """A node as the arena ids of its root path (comparable across the two
    packages' node objects)."""
    out = []
    while node is not None:
        out = list(node.blocks) + out
        node = node.parent
    return tuple(out)


def _obs(x):
    """Plain, comparable form of a return value."""
    if isinstance(x, (JPC._Node, TPC._Node)):
        return ("node", _path(x))
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.tolist())
    if isinstance(x, dict):
        return {k: _obs(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_obs(v) for v in x)
    return x


def case_insert_match_roundtrip(m, log):
    c = m.PrefixCache(n_blocks=8, block=B, block_bytes=100)
    log(c.insert(_toks(1, 2, 3)))
    log(c.match(_toks(1, 2, 3)))
    log(c.match(_toks(1) + [1] * (B - 1)))
    log(c.match(_toks(9, 9)))
    log(c.insert(_toks(1, 2, 3)))
    log(c.used_blocks, c.stats())


def case_split_mid_edge(m, log):
    c = m.PrefixCache(n_blocks=8, block=B, block_bytes=100)
    log(c.insert(_toks(1, 2, 3, 4)))
    log(c.insert(_toks(1, 2, 9)))
    log(c.match(_toks(1, 2, 3, 4)))
    log(c.match(_toks(1, 2, 9)))
    log(c.match(_toks(1, 2, 5)))


def case_refcount_protects_live_blocks(m, log):
    c = m.PrefixCache(n_blocks=2, block=B, block_bytes=100)
    c.insert(_toks(1, 2))
    n, _, node = c.match(_toks(1, 2))
    c.acquire(node)
    log(c.insert(_toks(7, 8)), c.match(_toks(1, 2)))
    c.release(node)
    log(c.insert(_toks(7, 8)), c.match(_toks(1, 2)), c.match(_toks(7, 8)))


def case_lru_eviction_respects_budget(m, log):
    c = m.PrefixCache(n_blocks=4, block=B, block_bytes=100)
    c.insert(_toks(1, 2))
    c.insert(_toks(3, 4))
    c.match(_toks(1, 2))
    log(c.insert(_toks(5, 6)), c.used_blocks)
    log(c.match(_toks(1, 2)), c.match(_toks(3, 4)), c.match(_toks(5, 6)))


def case_partial_alloc_when_exhausted(m, log):
    c = m.PrefixCache(n_blocks=3, block=B, block_bytes=100)
    log(c.insert(_toks(1, 2, 3, 4, 5)))
    log(c.match(_toks(1, 2, 3, 4, 5)), c.used_blocks)


def case_probes_ledger(m, log):
    c = m.PrefixCache(n_blocks=2, block=B, block_bytes=100)
    c.insert(_toks(1, 2))
    c.insert(_toks(3, 4))
    log(c.stats())


def case_adopted_mode(m, log):
    """The paged pool's mode: ids pinned and unpinned through callbacks."""
    refs = {}
    pin = lambda ids: [refs.__setitem__(i, refs.get(i, 0) + 1) for i in ids]  # noqa: E731
    unpin = lambda ids: [refs.__setitem__(i, refs[i] - 1) for i in ids]  # noqa: E731
    c = m.PrefixCache(n_blocks=3, block=B, block_bytes=100, pin=pin, unpin=unpin)
    log(c.insert(_toks(1, 2), n_blocks=2, block_ids=[11, 12, 13]))
    log(c.insert(_toks(1, 2, 3), n_blocks=3, block_ids=[21, 22, 23]))
    log(c.insert(_toks(5, 6), n_blocks=2, block_ids=[31, 32]), dict(refs))
    log(c.match(_toks(1, 2, 3)), c.used_blocks, c.stats())
    c.reset()
    log(dict(refs), c.used_blocks)


def case_host_tier_put_take_pop_once(m, log):
    st = m.HostTierStore(8, block_bytes=100)
    log(st.put((), [_K(1), _K(2)], _blob([1, 2])), st.used_blocks)
    log(st.take((), [_K(1), _K(2)]))
    log(st.take((), [_K(1), _K(2)]), st.used_blocks)


def case_host_tier_chains_across_entries(m, log):
    st = m.HostTierStore(8, block_bytes=100)
    st.put((), [_K(1)], _blob([1]))
    st.put((_K(1),), [_K(2), _K(3)], _blob([2, 3]))
    log(st.take((), [_K(1), _K(2), _K(3)]))


def case_host_tier_refiles_divergent_tail(m, log):
    st = m.HostTierStore(8, block_bytes=100)
    st.put((), [_K(1), _K(2), _K(3)], _blob([1, 2, 3]))
    log(st.take((), [_K(1), _K(2), _K(9)]))
    log(st.take((_K(1), _K(2)), [_K(3)]), st.used_blocks)


def case_host_tier_lru_eviction_and_trim(m, log):
    st = m.HostTierStore(3, block_bytes=100)
    st.put((), [_K(1), _K(2)], _blob([1, 2]))
    st.put((), [_K(3), _K(4)], _blob([3, 4]))
    log(st.used_blocks, st.take((), [_K(1)]), st.take((), [_K(3)]))
    st2 = m.HostTierStore(2, block_bytes=100)
    log(st2.put((), [_K(i) for i in range(4)], _blob(range(4))), st2.stats())
    st2.clear()
    log(st2.stats())


def case_tier2_demote_promote_roundtrip(m, log):
    arena = {}
    c = m.PrefixCache(n_blocks=2, block=B, block_bytes=100, tier2_blocks=4,
                      export=lambda ids: {"k": np.stack([arena[i] for i in ids])})
    _, _, new_ids = c.insert(_toks(1, 2))
    for i, a in enumerate(new_ids):
        arena[a] = np.full((3,), 10.0 + i, np.float32)
    c.insert(_toks(3, 4))
    n, _, node = c.match(_toks(1, 2))
    log(n, c.stats())
    log(c.match_t2(_toks(1, 2), 2, node, n))
    log(c.match_t2(_toks(1, 2), 2, node, n))


def case_tier2_budget_zero_is_single_tier(m, log):
    c = m.PrefixCache(n_blocks=2, block=B, block_bytes=100, tier2_blocks=0,
                      export=lambda ids: {})
    c2 = m.PrefixCache(n_blocks=2, block=B, block_bytes=100, tier2_blocks=4)
    log(c.tier2 is None, c2.tier2 is None, c.stats())


TREE_CASES = {f.__name__[5:]: f for f in (
    case_insert_match_roundtrip, case_split_mid_edge,
    case_refcount_protects_live_blocks, case_lru_eviction_respects_budget,
    case_partial_alloc_when_exhausted, case_probes_ledger, case_adopted_mode,
    case_host_tier_put_take_pop_once, case_host_tier_chains_across_entries,
    case_host_tier_refiles_divergent_tail, case_host_tier_lru_eviction_and_trim,
    case_tier2_demote_promote_roundtrip, case_tier2_budget_zero_is_single_tier,
)}


def _run_case(fn, mod, probes):
    probes.reset_prefix_stats()
    seen = []
    fn(mod, lambda *xs: seen.append(_obs(xs)))
    ledger = probes.prefix_stats()
    probes.reset_prefix_stats()
    return seen, ledger


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_and_host_tier_match_jax(case):
    got = _run_case(TREE_CASES[case], TPC, TP)
    want = _run_case(TREE_CASES[case], JPC, JP)
    assert got == want
    assert TP.prefix_stats()["counts"] == {}


def test_probes_ledger_matches_jax():
    """The server-side kinds, hit rates and the reset."""
    for p in (TP, JP):
        p.reset_prefix_stats()
        for kind, n in (("requests", 2), ("hit_requests", 1), ("hit_tokens", 16),
                        ("miss_tokens", 16), ("cached_bytes", 300),
                        ("cached_bytes", -100), ("t2_lookups", 4), ("t2_hits", 1),
                        ("copy_bytes", 64)):
            p.record_prefix(kind, n)
    got, want = TP.prefix_stats(), JP.prefix_stats()
    assert got == want and got["hit_rate"] == 0.5 and got["hit_rate_t2"] == 0.25
    for p in (TP, JP):
        p.reset_prefix_stats()
    assert TP.prefix_stats() == JP.prefix_stats()


def test_stage_ledger():
    TP.reset_stage_seconds()
    TP.record_stage("t2_h2d", 0.25, 3)
    TP.record_stage("t2_h2d", 0.5, 2)
    assert TP.stage_seconds() == {"t2_h2d": 0.75}
    assert TP.stage_items() == {"t2_h2d": 5}
    TP.reset_stage_seconds()
    assert TP.stage_seconds() == {}


# -- pool functions ------------------------------------------------------------

L, NH, HD, C, N_SLOTS, ARENA = 2, 4, 8, 48, 3, 5
JCFG16 = JD.DecoderConfig(vocab_size=64, hidden=NH * HD, layers=L, heads=NH,
                          intermediate=64, max_position=64, dtype=jnp.bfloat16)
TCFG16 = TD.DecoderConfig(vocab_size=64, hidden=NH * HD, layers=L, heads=NH,
                          intermediate=64, max_position=64, dtype=torch.bfloat16)


def _bits(x):
    """Array or tensor as numpy with its exact bit patterns."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _fill(pool, rng):
    """Seeded random contents for every KV plane of a JAX pool."""
    out = dict(pool)
    for k, v in pool.items():
        if k.endswith("_scale"):
            out[k] = jnp.asarray(rng.uniform(0.01, 0.05, v.shape), jnp.float32)
        elif v.dtype == jnp.int8:
            out[k] = jnp.asarray(rng.integers(-127, 128, v.shape), jnp.int8)
        elif v.dtype == jnp.bfloat16:
            out[k] = jnp.asarray(rng.standard_normal(v.shape), jnp.bfloat16)
        elif k == "slot_mask":
            out[k] = jnp.asarray(rng.integers(0, 2, v.shape), jnp.int32)
    return out


def _pools(paged, kv_quant, seed):
    rng = np.random.default_rng(seed)
    if paged:
        jpool = JD.paged_pool_init(None, JCFG16, N_SLOTS, C, 10, B, kv_quant=kv_quant)
        jpool = _fill(jpool, rng)
        jpool["kb"] = jpool["kb"].at[:, 0].set(0)
        jpool["vb"] = jpool["vb"].at[:, 0].set(0)
    else:
        jpool = _fill(JD.pool_init(None, JCFG16, N_SLOTS, C, arena_blocks=ARENA,
                                   arena_block=B, kv_quant=kv_quant), rng)
    tpool = from_jax_params(jax.tree.map(np.asarray, jpool))
    return jpool, tpool


def _same(tpool, jpool):
    assert set(tpool) == set(jpool)
    for k in jpool:
        np.testing.assert_array_equal(_bits(tpool[k]), _bits(jpool[k]), err_msg=k)


def test_pool_init_arena_matches_jax():
    for kv_quant in (False, True):
        jpool = JD.pool_init(None, JCFG16, N_SLOTS, C, arena_blocks=ARENA,
                             arena_block=B, kv_quant=kv_quant)
        tparams = {"wte": torch.zeros(1)}
        tpool = TD.pool_init(tparams, TCFG16, N_SLOTS, C, kv_quant=kv_quant,
                             arena_blocks=ARENA, arena_block=B)
        assert {k: (tuple(v.shape), _bits(v).dtype) for k, v in tpool.items()} == \
               {k: (tuple(v.shape), _bits(v).dtype) for k, v in jpool.items()}


# (slot, start, arena ids): block-aligned, unaligned (a left-padded miss,
# token 0 at column s - n), and starts past C - n*B that clamp
EXTRACT = [(1, 16, [2, 0]), (0, 13, [4]), (2, 45, [1, 3]), (1, 40, [0, 1, 2])]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("slot,start,idxs", EXTRACT)
def test_kv_extract_matches_jax(kv_quant, slot, start, idxs):
    jpool, tpool = _pools(False, kv_quant, seed=start)
    jpool = JD.kv_extract(jpool, jnp.int32(slot), jnp.int32(start),
                          jnp.asarray(idxs, jnp.int32), JCFG16)
    tpool = TD.kv_extract(tpool, slot, start, idxs)
    _same(tpool, jpool)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("slot,start,idxs", [(2, 0, [3, 1]), (0, 44, [4, 0])])
def test_kv_insert_matches_jax(kv_quant, slot, start, idxs):
    jpool, tpool = _pools(False, kv_quant, seed=7 + start)
    jpool = JD.kv_insert(jpool, jnp.int32(slot), jnp.int32(start),
                         jnp.asarray(idxs, jnp.int32), JCFG16)
    tpool = TD.kv_insert(tpool, slot, start, idxs)
    _same(tpool, jpool)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_pool_admit_cached_matches_jax(kv_quant):
    jpool, tpool = _pools(False, kv_quant, seed=3)
    jpool = JD.pool_admit_cached(jpool, jnp.int32(1), jnp.asarray([3, 0, 2], jnp.int32),
                                 JCFG16)
    tpool = TD.pool_admit_cached(tpool, 1, [3, 0, 2])
    _same(tpool, jpool)


@pytest.mark.parametrize("n_cached", [0, 16])
def test_paged_admit_cached_matches_jax(n_cached):
    jpool, tpool = _pools(True, False, seed=4)
    row = np.asarray([5, 2, 7, 0, 0, 0], np.int32)
    jpool = JD.paged_admit_cached(jpool, jnp.int32(2), jnp.asarray(row), n_cached)
    tpool = TD.paged_admit_cached(tpool, 2, row, n_cached)
    _same(tpool, jpool)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kv_block_export_import_match_jax(paged, kv_quant):
    jpool, tpool = _pools(paged, kv_quant, seed=5)
    idxs = [3, 1, 4]
    jblobs = JD.kv_block_export(jpool, jnp.asarray(idxs, jnp.int32))
    tblobs = TD.kv_block_export(tpool, idxs)
    assert set(tblobs) == set(jblobs)
    for c in jblobs:
        np.testing.assert_array_equal(_bits(tblobs[c]), _bits(jblobs[c]), err_msg=c)
    # import the same payload into other blocks
    dst = [2, 0, 1] if not paged else [6, 8, 9]
    jpool = JD.kv_block_import(jpool, jnp.asarray(dst, jnp.int32), jblobs)
    tpool = TD.kv_block_import(tpool, dst, tblobs)
    _same(tpool, jpool)


def test_block_moves_refuse_the_wrong_pool():
    _, dense = _pools(False, False, seed=6)
    _, paged = _pools(True, False, seed=6)
    with pytest.raises(ValueError, match="paged"):
        TD.kv_extract(paged, 0, 0, [1])
    with pytest.raises(ValueError, match="paged"):
        TD.kv_insert(paged, 0, 0, [1])
    with pytest.raises(ValueError, match="paged"):
        TD.pool_admit_cached(paged, 0, [1])
    blobs = TD.kv_block_export(dense, [0])
    del blobs["v"]
    with pytest.raises(ValueError, match="'v'"):
        TD.kv_block_import(dense, [1], blobs)


# -- two slots sharing a head: gather-run-scatter and kernel routes ------------

JCFG = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                        max_position=128, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                        max_position=128, dtype=torch.float32)


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


def _pieces(e, n_cached):
    n = len(e)
    W = n_cached + -((n_cached - n) // B) * B
    ids = np.zeros((1, W), np.int32)
    mask = np.zeros((1, W), np.int32)
    ids[0, :n], mask[0, :n] = e, 1
    pos = np.minimum(np.arange(W), n - 1)[None].astype(np.int32)
    lc = (n - 1) - (W - B)
    for o in range(n_cached, W, B):
        last = o + B >= W
        yield (ids[:, o:o + B], mask[:, o:o + B], pos[:, o:o + B], o, o == 0, last,
               None if (not last or lc == B - 1) else lc)


@pytest.mark.parametrize("paged_kernel", [False, True], ids=["gather", "kernel"])
def test_two_slots_sharing_a_head_match_jax(jparams, tparams, paged_kernel):
    """Slot 0 prefills a prompt; slots 1 and 2 share its first two blocks
    through their table rows (``paged_admit_cached``) and prefill only their
    suffixes; a decode chunk runs over all three. Tokens, logits and live KV
    equal JAX, and the shared blocks keep their bytes bit for bit."""
    rng = np.random.default_rng(0)
    head = rng.integers(1, 97, 2 * B).tolist()
    prompts = [head + rng.integers(1, 97, k).tolist() for k in (3, 5, 11)]
    M, n_blocks = C // B, 3 * (C // B) + 1
    jpool = JD.paged_pool_init(jparams, JCFG, 3, C, n_blocks, B)
    tpool = TD.paged_pool_init(tparams, TCFG, 3, C, n_blocks, B)
    rows = [np.arange(1, M + 1, dtype=np.int32) + s * M for s in range(3)]
    for s in (1, 2):
        rows[s][:2] = rows[0][:2]  # the shared head blocks
    for slot, e in enumerate(prompts):
        n_cached = 0 if slot == 0 else 2 * B
        jpool = JD.paged_admit_cached(jpool, jnp.int32(slot), jnp.asarray(rows[slot]),
                                      n_cached)
        tpool = TD.paged_admit_cached(tpool, slot, rows[slot], n_cached)
        for ids, mask, pos, o, first, last, lc in _pieces(e, n_cached):
            kw = dict(first=first, last=last, flash=True)
            jpool = JD.pool_prefill_chunk(
                jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos), jpool,
                jnp.int32(slot), jnp.int32(o), jnp.asarray([len(e)], jnp.int32), JCFG,
                last_col=None if lc is None else jnp.int32(lc), **kw)
            tpool = TD.pool_prefill_chunk(
                tparams, torch.from_numpy(ids), torch.from_numpy(mask),
                torch.from_numpy(pos), tpool, slot, o, len(e), TCFG, last_col=lc, **kw)
    shared = [tpool[k][:, rows[0][:2]].clone() for k in ("kb", "vb")]
    active = np.array([True, True, True])
    jpool, jt = JD.pool_decode_chunk(jparams, jpool, jnp.asarray(active),
                                     jax.random.PRNGKey(0), JCFG, 6,
                                     paged_kernel=paged_kernel)
    tpool, tt = TD.pool_decode_chunk(tparams, tpool, active, None, TCFG, 6,
                                     paged_kernel=paged_kernel)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tpool["logits"].numpy(), np.asarray(jpool["logits"]),
                               rtol=1e-4, atol=1e-5)
    for name in ("slot_mask", "pos", "write", "block_tbl"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    for k, before in zip(("kb", "vb"), shared):
        assert torch.equal(tpool[k][:, rows[0][:2]], before)
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]),
                                   rtol=1e-5, atol=1e-5)


def test_paged_scatter_skips_shared_and_sentinel_blocks():
    """The gather-run-scatter route writes back only blocks one row owns."""
    pool = TD.paged_pool_init({"wte": torch.zeros(1)}, TCFG, 2, 16, 6, B)
    TD.paged_table_set(pool, 0, [1, 2])
    TD.paged_table_set(pool, 1, [1, 0])
    view = TD._paged_gather(pool)
    for k in ("k", "v"):
        view[k].fill_(1.0)
    TD._paged_scatter(pool, view)
    for k in ("kb", "vb"):
        assert torch.all(pool[k][:, 2] == 1.0)
        assert torch.all(pool[k][:, [0, 1, 3]] == 0.0)


# -- serving ------------------------------------------------------------------

NEW = 8
HEAD = "rag sys prompt: "  # 16 chars: 2 blocks
POOLS = {
    "dense": dict(flash_prefill=True),
    "paged": dict(paged_kv=True, paged_kv_block=B, paged_kernel=True,
                  flash_prefill=True),
}
SPLITS = [HEAD + "t" * k for k in range(1, 10)]
LRU = [c * 16 + "?" for c in "abcdef"]
T2 = [c * 24 + "?" for c in "abcdef"] + ["a" * 24 + "?", "a" * 24 + "!"]


@pytest.fixture(scope="module")
def truth(jparams):
    """JAX static greedy generate (one left-padded batch, as the JAX
    package's prefix-cache tests take their truth)."""
    from pathway_tpu.xpacks.llm.llms import TPUDecoderChat

    uniq = sorted(set(SPLITS + LRU + T2))
    static = TPUDecoderChat(params=jparams, cfg=JCFG, tokenizer=ToyCharTokenizer(64),
                            max_new_tokens=NEW, temperature=0.0, max_prompt_tokens=32)
    return dict(zip(uniq, static.__wrapped__(uniq, max_new_tokens=NEW)))


def _chat(tparams, pool, **kw):
    return DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(64),
                       max_new_tokens=NEW, max_prompt_tokens=32, continuous=True,
                       n_slots=4, chunk_steps=4, pipeline_depth=2, prefill_chunk=B,
                       device="cpu", **POOLS[pool], **kw)


def _serve(chat, prompts, sequential):
    if sequential:
        reqs = []
        for p in prompts:
            r = chat.submit_batch([p])[0]
            assert r.done.wait(timeout=60)
            reqs.append(r)
    else:
        reqs = chat.submit_batch(prompts)
        for r in reqs:
            assert r.done.wait(timeout=60)
    assert chat.server.failed is None
    return [r.text for r in reqs]


@pytest.mark.parametrize("pool", list(POOLS))
def test_cache_off_equals_static(tparams, truth, pool):
    chat = _chat(tparams, pool, prefix_cache=False)
    try:
        got = _serve(chat, SPLITS, sequential=False)
        assert chat.server.prefix is None
        assert chat.server.stats["prefix_requests"] == 0
        assert "arena_k" not in chat.server.pool
    finally:
        chat.close()
    assert got == [truth[p] for p in SPLITS]


@pytest.mark.parametrize("pool", list(POOLS))
def test_sequential_hits_every_split_equal_static(tparams, truth, pool):
    """The first request inserts the head; every later one admits it from
    the cache, at every suffix split (1..9 tokens past two cached blocks:
    mid-block, a whole block, a suffix spilling into a second piece)."""
    TP.reset_prefix_stats()
    chat = _chat(tparams, pool)
    try:
        got = _serve(chat, SPLITS, sequential=True)
        st = chat.server.stats
        assert st["prefix_requests"] == len(SPLITS)
        assert st["prefix_hit_requests"] >= len(SPLITS) - 1
        assert st["prefix_hit_tokens"] >= (len(SPLITS) - 1) * 2 * B
        counts = TP.prefix_stats()["counts"]
        if pool == "dense":  # hits copy arena blocks; paged hits share them
            assert counts["copy_bytes"] == st["prefix_hit_tokens"] // B * chat.server.prefix.block_bytes
        else:
            assert "copy_bytes" not in counts
            assert chat.server._allocator.n_allocated == chat.server.prefix.used_blocks
    finally:
        chat.close()
    assert got == [truth[p] for p in SPLITS]


@pytest.mark.parametrize("pool", list(POOLS))
def test_burst_equal_static(tparams, truth, pool):
    """Same-tick admissions (misses) and later hits share one answer."""
    chat = _chat(tparams, pool)
    try:
        got = _serve(chat, SPLITS, sequential=False)
        assert chat.server.stats["prefix_hit_requests"] >= 1
    finally:
        chat.close()
    assert got == [truth[p] for p in SPLITS]


@pytest.mark.parametrize("pool", list(POOLS))
def test_lru_respects_byte_budget(tparams, truth, pool):
    """A 3-block budget serving 6 distinct 2-block prompts evicts instead
    of growing (block_bytes 2 * 2 layers * 4 heads * 8 * 8 * 4 B = 4 KiB)."""
    chat = _chat(tparams, pool, prefix_cache_mb=0.013)
    try:
        got = _serve(chat, LRU, sequential=True)
        prefix = chat.server.prefix
        assert prefix.capacity_blocks == 3
        assert 0 < prefix.used_blocks <= 3
        assert prefix.stats()["cached_bytes"] == prefix.used_blocks * prefix.block_bytes
        assert chat.server.stats["prefix_requests"] == len(LRU)
        if pool == "paged":
            assert chat.server._allocator.n_allocated == prefix.used_blocks
        chat.server.prefix_reset()
        assert chat.server.prefix.used_blocks == 0
        assert chat.server.stats["prefix_requests"] == 0
        if pool == "paged":
            assert chat.server._allocator.n_allocated == 0
    finally:
        chat.close()
    assert got == [truth[p] for p in LRU]


def _serve_t2(tparams, pool, t2_mb):
    """Six distinct 3-block heads churn a 3-block tier 1 (demoting under a
    tier-2 budget); the first head comes back (a tier-2 hit that promotes),
    then the same head once more (a tier-1 hit)."""
    TP.reset_prefix_stats()
    chat = _chat(tparams, pool, prefix_cache_mb=0.013, prefix_t2_mb=t2_mb)
    try:
        texts = _serve(chat, T2[:7], sequential=True)
        assert chat.server.t2_drain(timeout=30.0)
        texts += _serve(chat, T2[7:], sequential=True)
        srv = chat.server
        resident = srv.prefix.match(chat.tokenizer.encode("a" * 24))[0]
        return texts, dict(srv.stats), srv.prefix, resident, TP.prefix_stats()
    finally:
        chat.close()


@pytest.mark.parametrize("pool", list(POOLS))
def test_tier2_demote_promote_roundtrip(tparams, truth, pool):
    off, off_stats, off_prefix, _, off_ledger = _serve_t2(tparams, pool, 0.0)
    assert off_prefix.tier2 is None and off_stats["t2_hit_requests"] == 0
    assert off_ledger["t2_lookups"] == 0
    texts, stats, prefix, resident, s = _serve_t2(tparams, pool, 0.1)
    assert prefix.tier2 is not None
    assert stats["t2_hit_requests"] >= 1
    assert s["t2_lookups"] >= 1 and s["t2_hits"] >= 1 and s["hit_rate_t2"] > 0.0
    assert s["t2_demoted_blocks"] >= 3 * 3
    # the returning head's promotion landed before that request published
    # its own blocks, so every hit block came back, none was dropped
    assert stats["t2_promoted_blocks"] == s["t2_hit_blocks"] >= 1
    assert stats["t2_dropped"] == 0
    assert resident == 3 and stats["prefix_hit_requests"] >= 1
    assert texts == off == [truth[p] for p in T2]
