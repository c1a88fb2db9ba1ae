"""Shared helpers for the parity tests between ``pathway_tpu`` (JAX, the
reference) and ``pathway_tpu_torch`` (the port): matching small configs
and seeded numpy weights fed to both packages."""

import numpy as np
import jax.numpy as jnp
import torch

from pathway_tpu.models import transformer as JT
from pathway_tpu_torch.models import transformer as TT

SMALL = dict(vocab_size=1000, hidden=32, layers=2, heads=4, intermediate=64)

# The tier-1 suite runs six worker processes on eight cores, and every
# worker imports this module while collecting. One intra-op thread per
# process keeps the port's small-width tests from crowding out the JAX
# tests' own thread pools (the JAX continuous server's tests are sensitive
# to host scheduling, ROADMAP C).
torch.set_num_threads(1)


def configs(dtype: str = "float32"):
    """(JAX config, port config) of the small test encoder."""
    return (
        JT.TransformerConfig(**SMALL, dtype=getattr(jnp, dtype)),
        TT.TransformerConfig(**SMALL, dtype=getattr(torch, dtype)),
    )


def np_encoder_params(seed: int, emb_std: float = 0.02, w_std: float = 0.02):
    """Encoder weights in the JAX package's stacked layout, as numpy f32.
    Layernorm scales and biases are perturbed so they are exercised too."""
    rng = np.random.default_rng(seed)
    n, h, i = SMALL["layers"], SMALL["hidden"], SMALL["intermediate"]

    def normal(std, *shape):
        return rng.normal(0.0, std, shape).astype(np.float32)

    def ln(*shape):
        return (1.0 + normal(0.1, *shape)), normal(0.02, *shape)

    e_scale, e_bias = ln(h)
    l1_scale, l1_bias = ln(n, h)
    l2_scale, l2_bias = ln(n, h)
    return {
        "embeddings": {
            "word": normal(emb_std, SMALL["vocab_size"], h),
            "position": normal(emb_std, 512, h),
            "type": normal(emb_std, 2, h),
            "ln_scale": e_scale,
            "ln_bias": e_bias,
        },
        "layers": {
            "qkv_w": normal(w_std, n, h, 3 * h),
            "qkv_b": normal(0.02, n, 3 * h),
            "attn_out_w": normal(w_std, n, h, h),
            "attn_out_b": normal(0.02, n, h),
            "ln1_scale": l1_scale,
            "ln1_bias": l1_bias,
            "mlp_in_w": normal(w_std, n, h, i),
            "mlp_in_b": normal(0.02, n, i),
            "mlp_out_w": normal(w_std, n, i, h),
            "mlp_out_b": normal(0.02, n, h),
            "ln2_scale": l2_scale,
            "ln2_bias": l2_bias,
        },
        "pooler": {"w": normal(w_std, h, h), "b": normal(0.02, h)},
    }


def np_head(seed: int, std: float = 0.02):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(0.0, std, (SMALL["hidden"], 1)).astype(np.float32),
        "b": rng.normal(0.0, std, (1,)).astype(np.float32),
    }


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)
