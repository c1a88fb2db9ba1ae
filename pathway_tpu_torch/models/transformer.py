"""BERT-family transformer encoder in PyTorch (counterpart of
``pathway_tpu/models/transformer.py``).

Parameters are a plain dict of tensors with the JAX package's layout:
layers stacked along a leading ``(L, ...)`` axis, fused QKV. Matmul
inputs and outputs are in the compute dtype (bf16 by default; the card
accumulates in f32), layernorm statistics in f32, as in the JAX encoder.

Attention goes through the ``core(q, k, v)`` seam. By default the core is
``flash_attn(causal=False)``: the hand-written CUDA kernel for tensors on
the card, its plain version for tensors on the CPU. The other products
(QKV, attention out, MLP) are ``torch.matmul``, as the JAX package left
them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from pathway_tpu_torch.models.flash_attention import flash_attn


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_position: int = 512
    type_vocab: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16  # activation / compute dtype
    param_dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


MINILM_L6 = TransformerConfig(layers=6, hidden=384, heads=12, intermediate=1536)
MINILM_L12 = TransformerConfig(layers=12, hidden=384, heads=12, intermediate=1536)
BGE_SMALL = TransformerConfig(layers=12, hidden=384, heads=12, intermediate=1536)


def _normal(gen: torch.Generator, shape, dtype, scale=0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def init_params(seed: int, cfg: TransformerConfig) -> dict:
    """Seeded random parameters (on the CPU) in the JAX package's stacked
    layout. The values come from a CPU ``torch.Generator``, so one seed
    gives the same weights wherever they are moved (not the JAX package's
    values: its PRNG differs; tests share weights through
    ``params.from_jax_params``)."""
    gen = torch.Generator().manual_seed(int(seed))
    pd = cfg.param_dtype
    n, h, i = cfg.layers, cfg.hidden, cfg.intermediate

    def ones(*shape):
        return torch.ones(shape, dtype=pd)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd)

    params = {
        "embeddings": {
            "word": _normal(gen, (cfg.vocab_size, h), pd),
            "position": _normal(gen, (cfg.max_position, h), pd),
            "type": _normal(gen, (cfg.type_vocab, h), pd),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "qkv_w": _normal(gen, (n, h, 3 * h), pd),
            "qkv_b": zeros(n, 3 * h),
            "attn_out_w": _normal(gen, (n, h, h), pd),
            "attn_out_b": zeros(n, h),
            "ln1_scale": ones(n, h),
            "ln1_bias": zeros(n, h),
            "mlp_in_w": _normal(gen, (n, h, i), pd),
            "mlp_in_b": zeros(n, i),
            "mlp_out_w": _normal(gen, (n, i, h), pd),
            "mlp_out_b": zeros(n, h),
            "ln2_scale": ones(n, h),
            "ln2_bias": zeros(n, h),
        },
        "pooler": {
            "w": _normal(gen, (h, h), pd),
            "b": zeros(h),
        },
    }
    return params


def map_params(fn, tree):
    """Apply ``fn`` to every tensor of a nested param dict."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)


# Odd minimax-style fit of erf over |t|<=3.2 (erf(t) ~ t*P(t^2)); |t|>3.2
# clamps to sign(t). Copied from the JAX encoder, whose bf16 path uses it:
# max |gelu error| 1.9e-5, below bf16 resolution.
_ERF_POLY = (
    1.1283258790481554, -0.375708425265248, 0.11186609008719957,
    -0.025815739455015935, 0.0045846851469556376, -0.000611430760234131,
    5.848816009248211e-05, -3.741659781969581e-06, 1.4200819258585872e-07,
    -2.4020404766197523e-09,
)
_INV_SQRT2 = 0.7071067811865476


def _poly_gelu(x: torch.Tensor) -> torch.Tensor:
    """Erf gelu via the polynomial erf, evaluated in f32 and cast back to
    ``x.dtype`` (the JAX encoder's bf16 gelu, term for term)."""
    xf = x.float()
    t = torch.clamp(xf * _INV_SQRT2, -3.2, 3.2)
    u = t * t
    p = torch.full_like(u, _ERF_POLY[-1])
    for c in reversed(_ERF_POLY[:-1]):
        p = p * u + c
    erf = torch.where(xf.abs() >= 3.2 / _INV_SQRT2, torch.sign(xf), t * p)
    return (0.5 * xf * (1.0 + erf)).to(x.dtype)


def _gelu(x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Exact (erf) gelu; the polynomial form under bf16 compute."""
    if cfg.dtype == torch.bfloat16:
        return _poly_gelu(x)
    return F.gelu(x, approximate="none")


def _layer_norm(x, scale, bias, eps):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


def _dense(x, w, cfg: TransformerConfig):
    """Weight product in the compute dtype (inputs and output)."""
    return torch.matmul(x, w.to(cfg.dtype))


def _attention(x, lp, cfg: TransformerConfig, core):
    """x: (B, S, H) in compute dtype; lp: one layer's param slice.
    ``core(q, k, v) -> (B, nh, S, hd) f32`` owns scaling and masking."""
    B, S, H = x.shape
    nh, hd = cfg.heads, cfg.head_dim
    qkv = _dense(x, lp["qkv_w"], cfg) + lp["qkv_b"].to(cfg.dtype)
    q, k, v = (
        t.reshape(B, S, nh, hd).transpose(1, 2).contiguous()
        for t in qkv.split(H, dim=-1)
    )
    ctx = core(q, k, v).to(cfg.dtype)
    ctx = ctx.transpose(1, 2).reshape(B, S, H)
    return _dense(ctx, lp["attn_out_w"], cfg) + lp["attn_out_b"].to(cfg.dtype)


def _layer(x, lp, cfg: TransformerConfig, core):
    attn = _attention(x, lp, cfg, core)
    x = _layer_norm(x + attn, lp["ln1_scale"], lp["ln1_bias"],
                    cfg.layer_norm_eps).to(cfg.dtype)
    h = _dense(x, lp["mlp_in_w"], cfg)
    h = _gelu(h + lp["mlp_in_b"].to(cfg.dtype), cfg)
    h = _dense(h, lp["mlp_out_w"], cfg) + lp["mlp_out_b"].to(cfg.dtype)
    return _layer_norm(x + h, lp["ln2_scale"], lp["ln2_bias"],
                       cfg.layer_norm_eps).to(cfg.dtype)


def embed_inputs(params: dict, input_ids, cfg: TransformerConfig,
                 token_type_ids=None):
    """Word + position + type embeddings, layernormed, in compute dtype.
    ``token_type_ids`` defaults to all zeros (single segment)."""
    S = input_ids.shape[1]
    emb = params["embeddings"]
    x = emb["word"][input_ids.long()] + emb["position"][:S][None, :, :]
    if token_type_ids is None:
        x = x + emb["type"][0]
    else:
        x = x + emb["type"][token_type_ids.long()]
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], cfg.layer_norm_eps)
    return x.to(cfg.dtype)


def encode(params: dict, input_ids, attention_mask, cfg: TransformerConfig,
           token_type_ids=None, *, n_layers: int | None = None,
           core=None) -> torch.Tensor:
    """Encoder forward. Returns final hidden states (B, S, H) float32.

    ``n_layers`` truncates the depth to the first ``n_layers`` stacked
    layers. ``core`` replaces the attention inner; by default it is
    ``flash_attn(q, k, v, attention_mask, causal=False)``, the CUDA
    kernel on the card. Rows whose mask is all zero (bucket padding) come
    out of that core as zeros, where a dense softmax would average them:
    only live rows are comparable across the two."""
    x = embed_inputs(params, input_ids, cfg, token_type_ids)
    if core is None:
        mask = attention_mask.to(torch.int32).contiguous()

        def core(q, k, v):
            return flash_attn(q, k, v, mask, causal=False)

    layers = params["layers"]
    depth = cfg.layers if n_layers is None else min(n_layers, cfg.layers)
    for i in range(depth):
        x = _layer(x, {name: p[i] for name, p in layers.items()}, cfg, core)
    return x.float()


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()

