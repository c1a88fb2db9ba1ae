"""The port's chunk-vs-cache attention (plain versions of
``flash_chunk_attn`` and ``flash_chunk_attn_paged``; the CUDA kernel is held
against them on the card) against the JAX Pallas kernels run by the Pallas
interpreter, at the corners of ``tests/test_flash_prefill.py``: piece starts
0, 7 and 88 (a non-pow2 start, dead tiles past the piece), int8 K/V with
fused scales, and the paged variant over shuffled physical blocks.
Tolerance 1e-5: f32 both sides, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import flash_attention as JFA
from pathway_tpu_torch.models import flash_attention as TFA
from pathway_tpu_torch.models import paged_attention as TPA

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


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


@pytest.mark.parametrize("start", [0, 7, 88])
@pytest.mark.parametrize("quant", [False, True])
def test_dense_plain_version_matches_jax_kernel(start, quant):
    nh, T, C, hd = 4, 8, 96, 8
    q, k, v, ks, vs = _case(nh, T, C, hd, quant, seed=start)
    # holes in the live mask as well as the causal edge
    row_mask = (np.arange(C) < start + T).astype(np.int32)
    row_mask[::5] = 0
    want = np.asarray(JFA.flash_chunk_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(row_mask),
        jnp.int32(start), k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    got = TFA.flash_chunk_attn(_t(q), _t(k), _t(v), _t(row_mask), start,
                               k_scale=_t(ks), v_scale=_t(vs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_plain_version_matches_jax_kernel_and_dense(quant):
    nh, T, hd, blk, m, start = 4, 8, 8, 16, 6, 21
    rng = np.random.default_rng(4)
    n_blocks = 2 * m + 1
    q = rng.normal(0, 1, (nh, T, hd)).astype(np.float32)
    if quant:
        kb = rng.integers(-127, 128, (n_blocks, nh, blk, hd)).astype(np.int8)
        vb = rng.integers(-127, 128, (n_blocks, nh, blk, hd)).astype(np.int8)
        kbs = rng.uniform(0.01, 0.05, (n_blocks, nh, blk, 1)).astype(np.float32)
        vbs = rng.uniform(0.01, 0.05, (n_blocks, nh, blk, 1)).astype(np.float32)
    else:
        kb = rng.normal(0, 1, (n_blocks, nh, blk, hd)).astype(np.float32)
        vb = rng.normal(0, 1, (n_blocks, nh, blk, hd)).astype(np.float32)
        kbs = vbs = None
    kb[0], vb[0] = 0, 0  # the sentinel
    tbl = rng.permutation(np.arange(1, n_blocks))[:m].astype(np.int32)
    tbl[-1] = 0  # a sentinel tail past the live columns
    row_mask = (np.arange(m * blk) < start + T).astype(np.int32)
    want = np.asarray(JFA.flash_chunk_attn_paged(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
        None if kbs is None else jnp.asarray(kbs),
        None if vbs is None else jnp.asarray(vbs),
        jnp.asarray(tbl), jnp.asarray(row_mask), jnp.int32(start)))
    got = TFA.flash_chunk_attn_paged(_t(q), _t(kb), _t(vb), _t(kbs), _t(vbs),
                                     _t(tbl), _t(row_mask), start).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    rows = [TPA.gather_rows(_t(a), _t(tbl)[None])[0] if a is not None else None
            for a in (kb, vb, kbs, vbs)]
    dense = TFA.flash_chunk_attn(_t(q), rows[0], rows[1], _t(row_mask), start,
                                 k_scale=rows[2], v_scale=rows[3]).numpy()
    np.testing.assert_array_equal(got, dense)


def test_row_with_nothing_to_attend_is_zero():
    q, k, v, _, _ = _case(2, 4, 16, 8, False, seed=9)
    row_mask = np.zeros(16, np.int32)
    out = TFA.flash_chunk_attn(_t(q), _t(k), _t(v), _t(row_mask), 0).numpy()
    assert np.all(out == 0.0)


def test_paged_rejects_mask_table_mismatch():
    q, _, _, _, _ = _case(2, 4, 16, 8, False, seed=1)
    kb = torch.zeros((3, 2, 8, 8))
    with pytest.raises(ValueError):
        TFA.flash_chunk_attn_paged(_t(q), kb, kb, None, None,
                                   torch.tensor([1, 2], dtype=torch.int32),
                                   torch.ones(15, dtype=torch.int32), 0)
