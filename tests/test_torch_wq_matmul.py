"""The port's int8-weight matmul (plain version of ``wq_matmul``; the CUDA
kernel is held against it on the card) against the JAX Pallas kernel run by
the Pallas interpreter, at the ragged shapes of
``tests/test_weight_quant.py`` and the decoder's seam. Tolerance 1e-5: f32
accumulation of exact products both sides, in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.wq_matmul import wq_matmul as jwq
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models import wq_matmul as TWQ

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M,K,N", [(13, 32, 27), (1, 48, 8), (16, 64, 130), (70, 24, 5)])
def test_plain_version_matches_jax_kernel(M, K, N):
    rng = np.random.default_rng(M + N)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-1, (1, N)).astype(np.float32)
    want = np.asarray(jwq(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                          interpret=True))
    got = TWQ.wq_matmul(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_activations_accumulate_in_f32():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (8, 40)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.integers(-127, 128, (40, 12)).astype(np.int8))
    s = torch.full((12,), 0.01)
    want = (x.double() @ w.double()) * 0.01
    got = TWQ.wq_matmul(x, w, s)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def test_decoder_seam_routes_on_wq_kernel():
    """``cfg.wq_kernel`` sends the int8 product through ``wq_matmul`` (its
    plain version here); the result equals the einsum route."""
    import dataclasses

    rng = np.random.default_rng(0)
    cfg = TD.DecoderConfig(vocab_size=16, hidden=16, layers=1, heads=2,
                           intermediate=32, dtype=torch.float32)
    w = torch.from_numpy(rng.normal(0, 0.1, (16, 48)).astype(np.float32))
    q, s = TD._wq_quant(w, axis=-2)
    lp = {"qkv_w": q, "qkv_w_scale": s}
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 16)).astype(np.float32))
    a = TD._wq_matmul(x, lp, "qkv_w", cfg)
    b = TD._wq_matmul(x, lp, "qkv_w", dataclasses.replace(cfg, wq_kernel=True))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
