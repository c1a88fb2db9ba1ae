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

Weight-only int8 (``quantize_encoder_params``, JAX's
``PATHWAY_TPU_WEIGHT_QUANT=int8`` encoder seam): the four stacked layer
weights store int8 with one f32 scale per output channel, the word table
int8 with one f32 scale per vocab row. A ``word_scale`` key under
``embeddings`` marks the format. The four products dequantize in the read
as JAX's ``_wq_einsum`` does: the int8 payload widened to the compute
dtype, an f32 product, the scale on the output, then the cast; the
embedding gather scales only the gathered rows. Without the marker every
expression is the unquantized one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from pathway_tpu_torch.models.flash_attention import flash_attn
from pathway_tpu_torch.parallel.mesh import (
    SERVE_FSDP_AXIS,
    SERVE_TP_AXIS,
    P,
    ShardedTensor,
    gather_pytree,
    mesh_shape_error,
    place_pytree,
    spec_dropping_nondividing,
    spec_with_fsdp,
)


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


# ---- weight-only int8 (JAX transformer.py:128-194) -------------------------

_WQ_QMAX = 127.0
_WQ_SCALE_FLOOR = 1e-8
_WQ_ENC_LAYER_WEIGHTS = ("qkv_w", "attn_out_w", "mlp_in_w", "mlp_out_w")


def _wq_quant(w: torch.Tensor, axis: int):
    """Symmetric int8 over the contracted ``axis``; the f32 scale keeps a
    size-1 dim there (one scale per output channel). Never clips."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / _WQ_QMAX, min=_WQ_SCALE_FLOOR)
    return torch.round(wf / scale).to(torch.int8), scale


def parse_weight_quant(raw) -> str:
    """A ``weight_quant=`` argument: ``"int8"`` turns int8 on, ``None``
    leaves full precision; any other value raises."""
    if raw is None:
        return ""
    if isinstance(raw, str) and raw == "int8":
        return "int8"
    raise ValueError(f"weight_quant must be 'int8' or None, got {raw!r}")


def encoder_params_quantized(params: dict) -> bool:
    """True when ``params`` store int8 weights (:func:`quantize_encoder_params`)."""
    return "word_scale" in params["embeddings"]


def quantize_encoder_params(params: dict, out: dict | None = None) -> dict:
    """int8-quantize the word table (per vocab row) and the four stacked
    layer weights (per output channel). Quantize from the full-precision
    ``params``: a copy already cast to bf16 would bake the cast's mantissa
    loss into the scales. ``out`` is the tree the other leaves come from
    (the embedder passes its compute-dtype cast), so payloads stay int8
    and scales f32 while everything else keeps the caller's storage."""
    out = dict(out if out is not None else params)
    emb = dict(out["embeddings"])
    emb["word"], emb["word_scale"] = _wq_quant(params["embeddings"]["word"], axis=-1)
    out["embeddings"] = emb
    layers = dict(out["layers"])
    for name in _WQ_ENC_LAYER_WEIGHTS:
        layers[name], layers[name + "_scale"] = _wq_quant(params["layers"][name], axis=-2)
    out["layers"] = layers
    return out


def _dense(x, lp: dict, name: str, cfg: TransformerConfig):
    """The weight-product seam: in the compute dtype (inputs and output)
    when ``lp`` has no ``{name}_scale``; otherwise the int8 payload
    widened, an f32 product (every product of two bf16 values is exact in
    f32, as in JAX's f32-accumulating einsum), the per-channel scale, then
    the cast."""
    w = lp[name]
    scale = lp.get(name + "_scale")
    if scale is None:
        return torch.matmul(x, w.to(cfg.dtype))
    out = torch.matmul(x.float(), w.float())
    return (out * scale).to(cfg.dtype)


def param_partition_specs(cfg: TransformerConfig, tp_axis: str = "tp") -> dict:
    """Megatron layout: QKV and MLP-in shard their output features,
    attn-out and MLP-out their input features, the embeddings the vocab."""
    t = tp_axis
    return {
        "embeddings": {
            "word": P(t, None),
            "position": P(None, None),
            "type": P(None, None),
            "ln_scale": P(None),
            "ln_bias": P(None),
        },
        "layers": {
            "qkv_w": P(None, None, t),
            "qkv_b": P(None, t),
            "attn_out_w": P(None, t, None),
            "attn_out_b": P(None, None),
            "ln1_scale": P(None, None),
            "ln1_bias": P(None, None),
            "mlp_in_w": P(None, None, t),
            "mlp_in_b": P(None, t),
            "mlp_out_w": P(None, t, None),
            "mlp_out_b": P(None, None),
            "ln2_scale": P(None, None),
            "ln2_bias": P(None, None),
        },
        "pooler": {"w": P(None, t), "b": P(t)},
    }


def validate_encoder_mesh(cfg: TransformerConfig, mesh) -> None:
    """Typed ``MeshShapeError`` when ``cfg`` cannot shard over the serving
    mesh's tp axis (heads, ffn features and vocab must divide)."""
    tp = int(mesh.shape.get(SERVE_TP_AXIS, 1))
    bad = [f"{name}={v}" for name, v in (("heads", cfg.heads),
                                         ("intermediate", cfg.intermediate),
                                         ("vocab_size", cfg.vocab_size)) if v % tp]
    if bad:
        raise mesh_shape_error(
            f"encoder config does not divide the tp axis: {', '.join(bad)} "
            f"% tp={tp} != 0", mesh)


def shard_encoder_params(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """Encoder params placed on the ``(data, fsdp, tp)`` serving mesh: the
    Megatron layout with the fsdp axis overlaid on each leaf's first
    unsharded divisible dim. Placement is lenient, as in JAX: a dim the
    axes do not divide (the 30,522-row vocab over tp=4) replicates
    (``validate_encoder_mesh`` is the strict check). An int8 ``*_scale``
    plane takes its payload's spec. :func:`encode` gathers a sharded tree
    on use (ZeRO-3), so the outputs are the host encode's. No-op without a
    mesh; a one-position mesh is plain placement."""
    if mesh is None:
        return params
    fsdp = int(mesh.shape.get(SERVE_FSDP_AXIS, 1))
    specs = param_partition_specs(cfg, tp_axis=SERVE_TP_AXIS)

    def walk(node, sp):
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf, sp[name])
                continue
            if name in sp:
                base = sp[name]
            elif name.endswith("_scale") and name[:-len("_scale")] in sp:
                base = sp[name[:-len("_scale")]]
            else:
                raise KeyError(f"no partition spec for encoder param {name!r}")
            s = spec_dropping_nondividing(base, leaf.shape, mesh)
            out[name] = spec_with_fsdp(s, tuple(leaf.shape), fsdp)
        return out

    return place_pytree(params, mesh, walk(params, specs))


def _qkv_heads(x, lp, cfg: TransformerConfig):
    """The fused QKV projection of x (B, S, H), head-split: yields q, k, v,
    each a contiguous (B, nh, S, hd)."""
    B, S, H = x.shape
    nh, hd = cfg.heads, cfg.head_dim
    qkv = _dense(x, lp, "qkv_w", cfg) + lp["qkv_b"].to(cfg.dtype)
    return (t.reshape(B, S, nh, hd).transpose(1, 2).contiguous()
            for t in qkv.split(H, dim=-1))


def _attn_out(ctx, lp, cfg: TransformerConfig):
    """The output projection of an attention context (B, nh, S, hd)."""
    B, nh, S, hd = ctx.shape
    ctx = ctx.to(cfg.dtype).transpose(1, 2).reshape(B, S, nh * hd)
    return _dense(ctx, lp, "attn_out_w", cfg) + lp["attn_out_b"].to(cfg.dtype)


def _attention(x, lp, cfg: TransformerConfig, core):
    """x: (B, S, H) in compute dtype; lp: one layer's param slice.
    ``core(q, k, v) -> (B, nh, S, hd) f32`` owns scaling and masking."""
    q, k, v = _qkv_heads(x, lp, cfg)
    return _attn_out(core(q, k, v), lp, cfg)


def _layer_rest(x, attn, lp, cfg: TransformerConfig):
    """A layer after its attention: residual LN, the MLP, residual LN."""
    x = _layer_norm(x + attn, lp["ln1_scale"], lp["ln1_bias"],
                    cfg.layer_norm_eps).to(cfg.dtype)
    h = _dense(x, lp, "mlp_in_w", cfg)
    h = _gelu(h + lp["mlp_in_b"].to(cfg.dtype), cfg)
    h = _dense(h, lp, "mlp_out_w", cfg) + lp["mlp_out_b"].to(cfg.dtype)
    return _layer_norm(x + h, lp["ln2_scale"], lp["ln2_bias"],
                       cfg.layer_norm_eps).to(cfg.dtype)


def _layer(x, lp, cfg: TransformerConfig, core):
    return _layer_rest(x, _attention(x, lp, cfg, core), lp, cfg)


def embed_inputs(params: dict, input_ids, cfg: TransformerConfig,
                 token_type_ids=None):
    """Word + position + type embeddings, layernormed, in compute dtype.
    ``token_type_ids`` defaults to all zeros (single segment)."""
    S = input_ids.shape[1]
    emb = params["embeddings"]
    ids = input_ids.long()
    rows = emb["word"][ids]
    ws = emb.get("word_scale")
    if ws is not None:
        # dequant in the gather: the gathered rows, never the table; the
        # f32 rows promote the residual sum to f32, as in JAX
        rows = rows.float() * ws[ids]
    x = rows + emb["position"][:S][None, :, :]
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
    only live rows are comparable across the two. A sharded ``params``
    tree (:func:`shard_encoder_params`) is gathered first."""
    if isinstance(params["embeddings"]["word"], ShardedTensor):
        params = gather_pytree(params)
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

