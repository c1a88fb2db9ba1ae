"""The port's paged-attention decode (plain version; the CUDA kernel is held
against it on the card) against the JAX Pallas kernel run by the Pallas
interpreter, at the (heads, block, seq) corners and int8 K/V of
``tests/test_paged_kv.py``. Tolerance 1e-5: both are f32 online or dense
softmax over the same f32 values, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import paged_attention as JPA
from pathway_tpu_torch.models import paged_attention as TPA
from tests.test_paged_kv import _kernel_case

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _both(q, kb, vb, ks, vs, tbl, mask):
    want = np.asarray(JPA.paged_attn_decode(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        jnp.asarray(tbl), jnp.asarray(mask)))
    got = TPA.paged_attn_decode(_t(q), _t(kb), _t(vb), _t(ks), _t(vs), _t(tbl),
                                _t(mask)).numpy()
    return got, want


@pytest.mark.parametrize("nh,Bk,M", [(1, 8, 1), (4, 8, 3), (2, 16, 2), (4, 16, 4)])
@pytest.mark.parametrize("quant", [False, True])
def test_plain_version_matches_jax_kernel(nh, Bk, M, quant):
    got, want = _both(*_kernel_case(nh, Bk, M, quant))
    np.testing.assert_allclose(got, want, **TOL)


def test_empty_slot_and_sentinel_tail():
    """An empty slot is exact zeros; a table tail of sentinel blocks (masked
    columns) changes nothing."""
    q, kb, vb, ks, vs, tbl, mask = _kernel_case(2, 8, 3, False, seed=1)
    mask[1, :] = 0
    mask[2, 8:] = 0
    tbl[2, 1:] = 0
    got, want = _both(q, kb, vb, ks, vs, tbl, mask)
    assert np.all(got[1] == 0.0) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_output_dtype_follows_q():
    q, kb, vb, ks, vs, tbl, mask = _kernel_case(2, 8, 2, True, seed=2)
    out = TPA.paged_attn_decode(_t(q).bfloat16(), _t(kb), _t(vb), _t(ks), _t(vs),
                                _t(tbl), _t(mask))
    assert out.dtype == torch.bfloat16


def test_rejects_mask_table_mismatch():
    q, kb, vb, ks, vs, tbl, mask = _kernel_case(2, 8, 2, False)
    with pytest.raises(ValueError):
        TPA.paged_attn_decode(_t(q), _t(kb), _t(vb), None, None, _t(tbl),
                              _t(mask[:, :-1]))
