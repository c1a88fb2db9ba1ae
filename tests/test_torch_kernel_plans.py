"""The host-side plans of the port's split kernels and the plain versions of
their split-and-combine rules, on the CPU.

``chunk_plan`` (csrc/flash_chunk.cu, bf16 queries) cuts the live cache
columns into splits; ``decode_plan`` (csrc/paged_attn.cu, bf16 queries)
cuts each slot's block-table row; ``wq_plan`` (csrc/wq_matmul.cu, bf16 x)
cuts K. Each must cover its range exactly once and fill the 132 SMs at the
main-path shapes; the chunk plan also sizes the workspace of partials. The kernels themselves
are held against their plain versions on the card
(``tests/test_torch_kernels_cuda.py``); here
``flash_chunk_split_reference`` and ``paged_attn_decode_split_reference``
-- per-split m, l and acc combined in split order, the kernels' arithmetic
in f32 -- are held against the JAX Pallas kernels (interpreter, as
``tests/test_torch_flash_chunk.py`` and ``tests/test_torch_paged_attention.py``
run them) and against the port's single-softmax plain versions. Tolerance
1e-5: f32 both sides, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import flash_attention as JFA
from pathway_tpu.models import paged_attention as JPA
from tests.test_paged_kv import _kernel_case
from pathway_tpu_torch import kernels
from pathway_tpu_torch.models import flash_attention as TFA
from pathway_tpu_torch.models import paged_attention as TPA
from pathway_tpu_torch.models import wq_matmul as TWQ

TOL = dict(rtol=1e-5, atol=1e-5)

# the decoder main path: GPT-2 small, 12 heads x 64, a 64-token piece at
# column 448 of a 704-column cache; decode rows 16, prefill rows 64
MAIN_CHUNK = dict(nh=12, T=64, C=704, start=448, hd=64)
WQ_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("T", [1, 5, 40, 64, 70])
@pytest.mark.parametrize("C,start", [(64, 0), (96, 7), (704, 448), (704, 640),
                                     (128, 45), (4096, 4000), (48, 40)])
def test_chunk_plan_covers_live_columns_once(T, C, start):
    plan = TFA.chunk_plan(4, T, C, start, 64)
    live_end = min(C, start + T)
    assert plan.live_end == live_end
    cols = np.zeros(C, np.int64)
    for lo, hi in plan.splits():
        assert lo < hi and lo <= start + T - 1  # no split starts past the last query
        cols[lo:hi] += 1
    assert np.all(cols[:live_end] == 1) and np.all(cols[live_end:] == 0)
    assert plan.split_cols % TFA.SPLIT_UNIT == 0
    assert plan.n_splits <= TFA.MAX_SPLITS
    assert plan.q_tiles == -(-T // TFA.QUERY_TILE)


@pytest.mark.parametrize("block", [8, 16, 32, 64])
def test_chunk_split_boundaries_do_not_depend_on_the_block(block):
    """The paged variant sees C = blocks x block columns; its splits are
    those of the dense row of the same width, so both variants combine the
    same partials and agree bit for bit."""
    dense = TFA.chunk_plan(12, 64, 704, 448, 64)
    paged = TFA.chunk_plan(12, 64, (704 // block) * block, 448, 64)
    assert paged.splits() == dense.splits()


def test_chunk_plan_fills_the_card_at_the_main_path_shape():
    assert TFA.chunk_plan(**MAIN_CHUNK).blocks(MAIN_CHUNK["nh"]) >= kernels.SMS


@pytest.mark.parametrize("split_cols", TFA.SPLIT_CANDIDATES)
def test_chunk_candidates_grids(split_cols):
    plan = TFA.chunk_plan(**MAIN_CHUNK, split_cols=split_cols)
    assert plan.n_splits == 512 // split_cols and plan.q_tiles == 1


@pytest.mark.parametrize("nh,T,C,start,hd", [(12, 64, 704, 448, 64), (2, 5, 48, 40, 128),
                                             (3, 70, 256, 100, 40), (1, 8, 64, 0, 8)])
def test_chunk_workspace_sizes(nh, T, C, start, hd):
    plan = TFA.chunk_plan(nh, T, C, start, hd)
    if plan.n_splits == 1:
        assert plan.part_floats == 0
    else:
        # acc (heads, splits, T, hd), then (m, l) (heads, splits, T, 2)
        assert plan.part_floats == nh * plan.n_splits * T * hd + nh * plan.n_splits * T * 2


@pytest.mark.parametrize("M", [1, 16, 64, 65, 200, 8192])
@pytest.mark.parametrize("K,N", list(WQ_SHAPES) + [(100, 27), (100, 2309), (64, 130)])
def test_wq_plan_covers_k_and_rows(M, K, N):
    plan = TWQ.wq_plan(M, K, N)
    assert plan.k_per_split % 16 == 0
    assert (plan.n_splits - 1) * plan.k_per_split < K <= plan.n_splits * plan.k_per_split
    row_tiles = -(-M // TWQ.TILE_M)
    per_group = -(-row_tiles // plan.row_groups)  # as the kernel computes it
    assert (plan.row_groups - 1) * per_group < row_tiles <= plan.row_groups * per_group
    assert plan.n_tiles == -(-N // TWQ.TILE_N)
    assert 1 <= plan.n_splits <= TWQ.MAX_SPLITS  # one cluster a column tile


@pytest.mark.parametrize("M", [16, 64])
@pytest.mark.parametrize("K,N", WQ_SHAPES)
def test_wq_plan_fills_the_card_at_the_decoder_shapes(M, K, N):
    assert TWQ.wq_plan(M, K, N).blocks >= kernels.SMS


def _case(nh, T, C, hd, quant, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (nh, T, hd)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, (nh, C, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (nh, C, hd)).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, (nh, C, 1)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (nh, C, 1)).astype(np.float32)
    else:
        k = rng.normal(0, 1, (nh, C, hd)).astype(np.float32)
        v = rng.normal(0, 1, (nh, C, hd)).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs


@pytest.mark.parametrize("split_cols", [32, 64])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T,C,start,dead_to", [(8, 96, 0, 0), (8, 160, 88, 0),
                                               (20, 128, 45, 0), (16, 128, 20, 24),
                                               (6, 192, 150, 100)])
def test_split_reference_matches_jax_kernel(T, C, start, dead_to, quant, split_cols):
    """Split boundaries off the query grid, a last split partly dead, rows
    with no live column (dead_to), and whole dead splits (holes)."""
    nh, hd = 2, 16
    q, k, v, ks, vs = _case(nh, T, C, hd, quant, seed=C + start)
    row_mask = (np.arange(C) < start + T).astype(np.int32)
    row_mask[::5] = 0
    row_mask[:dead_to] = 0
    want = np.asarray(JFA.flash_chunk_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(row_mask),
        jnp.int32(start), k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    got = TFA.flash_chunk_split_reference(_t(q), _t(k), _t(v), _t(row_mask), start,
                                          k_scale=_t(ks), v_scale=_t(vs),
                                          split_cols=split_cols)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = TFA.flash_chunk_attn_reference(_t(q), _t(k), _t(v), _t(row_mask), start,
                                           k_scale=_t(ks), v_scale=_t(vs))
    torch.testing.assert_close(got, plain, **TOL)
    dead = start + np.arange(T) < dead_to
    assert np.all(got.numpy()[:, dead] == 0.0)


@pytest.mark.parametrize("quant", [False, True])
def test_split_reference_matches_jax_paged_kernel(quant):
    nh, T, hd, blk, m, start = 2, 8, 16, 16, 8, 61
    rng = np.random.default_rng(5)
    n_blocks = 2 * m + 1
    q = rng.normal(0, 1, (nh, T, hd)).astype(np.float32)
    if quant:
        kb, vb = (rng.integers(-127, 128, (n_blocks, nh, blk, hd)).astype(np.int8) for _ in range(2))
        kbs, vbs = (rng.uniform(0.01, 0.05, (n_blocks, nh, blk, 1)).astype(np.float32)
                    for _ in range(2))
    else:
        kb, vb = (rng.normal(0, 1, (n_blocks, nh, blk, hd)).astype(np.float32) for _ in range(2))
        kbs = vbs = None
    kb[0], vb[0] = 0, 0
    tbl = rng.permutation(np.arange(1, n_blocks))[:m].astype(np.int32)
    tbl[-2:] = 0  # sentinel tail past the live columns
    row_mask = (np.arange(m * blk) < start + T).astype(np.int32)
    row_mask[10:40] = 0  # a whole dead split of 32
    want = np.asarray(JFA.flash_chunk_attn_paged(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
        None if kbs is None else jnp.asarray(kbs), None if vbs is None else jnp.asarray(vbs),
        jnp.asarray(tbl), jnp.asarray(row_mask), jnp.int32(start)))
    rows = [None if a is None else TPA.gather_rows(_t(a), _t(tbl)[None])[0]
            for a in (kb, vb, kbs, vbs)]
    got = TFA.flash_chunk_split_reference(_t(q), rows[0], rows[1], _t(row_mask), start,
                                          k_scale=rows[2], v_scale=rows[3])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_split_reference_wide_splits_match_plain(quant):
    """More live columns than MAX_SPLITS splits of 32 hold: the plan widens
    the splits; the combine still equals one softmax."""
    nh, T, C, hd, start = 1, 4, 4096, 8, 4000
    q, k, v, ks, vs = _case(nh, T, C, hd, quant, seed=11)
    row_mask = (np.arange(C) < start + T).astype(np.int32)
    row_mask[1000:1500] = 0
    assert TFA.chunk_plan(nh, T, C, start, hd).split_cols == 64
    got = TFA.flash_chunk_split_reference(_t(q), _t(k), _t(v), _t(row_mask), start,
                                          k_scale=_t(ks), v_scale=_t(vs))
    plain = TFA.flash_chunk_attn_reference(_t(q), _t(k), _t(v), _t(row_mask), start,
                                           k_scale=_t(ks), v_scale=_t(vs))
    torch.testing.assert_close(got, plain, **TOL)


def test_split_reference_all_dead_is_zero():
    q, k, v, _, _ = _case(2, 4, 96, 8, False, seed=3)
    out = TFA.flash_chunk_split_reference(_t(q), _t(k), _t(v), torch.zeros(96, dtype=torch.int32), 50)
    assert torch.all(out == 0.0)


# the decoder main path's paged decode: 16 slots x 12 heads, 11 table
# entries of 64 columns (cache_len 704)
MAIN_DECODE = dict(B=16, nh=12, M=11, Bk=64)


@pytest.mark.parametrize("split_cols", TPA.SPLIT_CANDIDATES + (8, 64))
@pytest.mark.parametrize("M,Bk", [(1, 64), (11, 64), (6, 8), (4, 16), (100, 8), (9, 32), (3, 128)])
def test_decode_plan_covers_every_entry_once(M, Bk, split_cols):
    plan = TPA.decode_plan(M, Bk, split_cols)
    seen = np.zeros(M, np.int64)
    for lo, hi in plan.splits(M):
        assert lo < hi  # no empty split
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    assert 1 <= plan.n_splits <= TPA.MAX_SPLITS  # one portable cluster
    assert (plan.n_splits - 1) * plan.entries < M <= plan.n_splits * plan.entries


def test_decode_plan_fills_the_card_at_the_main_path_shape():
    B, nh, M, Bk = MAIN_DECODE.values()
    plan = TPA.decode_plan(M, Bk)
    assert plan.blocks(B, nh) >= kernels.SMS
    assert plan == TPA.DecodePlan(entries=4, n_splits=3)


@pytest.mark.parametrize("split_cols", TPA.SPLIT_CANDIDATES)
def test_decode_candidates_grids(split_cols):
    B, nh, M, Bk = MAIN_DECODE.values()
    plan = TPA.decode_plan(M, Bk, split_cols)
    assert plan.entries == split_cols // Bk and plan.blocks(B, nh) >= kernels.SMS


def _jax_paged(q, kb, vb, ks, vs, tbl, mask):
    return np.asarray(JPA.paged_attn_decode(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
        jnp.asarray(tbl), jnp.asarray(mask)))


@pytest.mark.parametrize("split_cols", [8, 16, 32])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh,Bk,M", [(1, 8, 1), (4, 8, 3), (2, 16, 2), (4, 16, 4)])
def test_decode_split_reference_matches_jax_kernel(nh, Bk, M, quant, split_cols):
    """The corners of tests/test_paged_kv.py's kernel case, with splits of
    one or more table entries."""
    case = _kernel_case(nh, Bk, M, quant)
    want = _jax_paged(*case)
    got = TPA.paged_attn_decode_split_reference(*(_t(a) for a in case), split_cols=split_cols)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = TPA.paged_attn_decode_reference(*(_t(a) for a in case))
    torch.testing.assert_close(got, plain, **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_split_reference_edges_match_jax_kernel(quant):
    """An empty slot (every split dead), a sentinel tail, a non-prefix mask
    with a whole dead split, and one live column in the last block."""
    q, kb, vb, ks, vs, tbl, mask = _kernel_case(4, 8, 4, quant, seed=3)
    mask[0, :] = 0
    mask[1, :] = 0
    mask[1, 31] = 1
    mask[2, :] = (np.arange(32) % 3 == 0)
    mask[2, 8:16] = 0
    mask[2, 24:] = 0
    tbl[2, 3] = 0
    assert TPA.decode_plan(4, 8, 8).n_splits == 4  # the dead entry is a split
    for split_cols in (8, 16):
        got = TPA.paged_attn_decode_split_reference(
            *(_t(a) for a in (q, kb, vb, ks, vs, tbl, mask)), split_cols=split_cols).numpy()
        np.testing.assert_allclose(got, _jax_paged(q, kb, vb, ks, vs, tbl, mask), **TOL)
        assert np.all(got[0] == 0.0) and np.isfinite(got).all()
