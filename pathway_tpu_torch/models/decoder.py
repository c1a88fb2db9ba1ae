"""Causal decoder-only transformer (GPT-2 family) with KV-cache decode and
the serving slot pools, in PyTorch (counterpart of
``pathway_tpu/models/decoder.py``).

Parameters are a plain dict of tensors in the JAX package's layout: layers
stacked on a leading ``(L, ...)`` axis, fused QKV, the LM head tied to
``wte``. Numerics follow the JAX decoder: weight products in the compute
dtype (the card accumulates in f32 and rounds once), attention scores,
layernorm statistics and logits in f32, tanh-approximate gelu.

Kernel seams, each the hand-written CUDA kernel for tensors on the card and
its plain PyTorch version for tensors on the CPU:

* ``flash_attn(causal=True)`` for whole-prompt prefill with ``flash=True``;
* ``flash_chunk_attn`` / ``flash_chunk_attn_paged`` for chunked-prefill
  pieces with ``flash=True`` (dense / paged pool);
* ``paged_attn_decode`` for decode chunks over a paged pool with
  ``paged_kernel=True``;
* ``wq_matmul`` for the four layer weights when they are int8 and
  ``DecoderConfig.wq_kernel`` is set.

Self-speculative decode (``pool_decode_draft``, ``pool_decode_spec``) is
plain torch ops around the same weight-product seam: a draft step runs
its products at M = slots, a verify at M = slots * (k + 1).

The prefix cache's block moves (``kv_extract``, ``kv_insert``,
``pool_admit_cached``, ``paged_admit_cached``, ``kv_block_export``,
``kv_block_import``) are data movement: indexed reads and writes, no
kernel.

Under a serving mesh (``shard_decoder_params``, ``shard_pool``) the blocks
are Megatron tensor-parallel over the ``tp`` axis: ``qkv`` and ``mlp_in``
column-sharded, ``attn_out`` and ``mlp_out`` row-sharded with an
``all_reduce_sum`` after each, the tied LM head vocab-sharded with its
logits all-gathered. The KV planes (int8 scales and arena included) are
head-sharded ``ShardedTensor`` planes, each shard its own contiguous
tensor, so every pool op runs its KV code once per shard and each
attention kernel launches once per tp shard on that shard's heads (JAX's
``shard_map``, no collective). ``fsdp`` shards are stored and gathered at
each pool op (ZeRO-3); ``data`` replicates. No mesh, or a one-position
mesh, runs the single-device code.

Unlike JAX, the pool functions update the pool dict IN PLACE (the KV
planes are the dominant device object; JAX donated them for the same
reason) and return it. Where JAX clamps a slice start
(``dynamic_update_slice``) or a gather index (``wpe[p]``), the port clamps
explicitly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from pathway_tpu_torch.device import to_device
from pathway_tpu_torch.models.flash_attention import (
    flash_attn,
    flash_chunk_attn,
    flash_chunk_attn_paged,
)
from pathway_tpu_torch.models.paged_attention import gather_rows, paged_attn_decode
from pathway_tpu_torch.models.transformer import map_params
from pathway_tpu_torch.models.wq_matmul import wq_matmul
from pathway_tpu_torch.parallel.mesh import (
    SERVE_FSDP_AXIS,
    SERVE_TP_AXIS,
    P,
    ShardedTensor,
    all_gather,
    all_reduce_sum,
    axis_shards,
    mesh_is_trivial,
    mesh_shape_error,
    place_pytree,
    spec_dropping_nondividing,
    spec_with_fsdp,
    split,
    tree_mesh,
    tree_position_bytes,
)

# the kernel seams: once per shard on head-sharded operands, else once
_per_shard = ShardedTensor.map


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 50257
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # routes the int8-weight products through the wq_matmul kernel
    wq_kernel: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


GPT2_SMALL = DecoderConfig()


def init_params(gen: torch.Generator, cfg: DecoderConfig) -> dict:
    """Seeded random parameters on the CPU in the JAX layout, drawn from the
    CPU generator ``gen``. The values are not the JAX package's (its PRNG
    differs); tests share weights through ``params.from_jax_params``."""
    pd = cfg.param_dtype
    n, h, i = cfg.layers, cfg.hidden, cfg.intermediate

    def normal(shape, scale=0.02):
        return (torch.randn(shape, generator=gen) * scale).to(pd)

    def stack(shape):
        return normal((n, *shape))

    return {
        "wte": normal((cfg.vocab_size, h)),
        "wpe": normal((cfg.max_position, h), 0.01),
        "layers": {
            "ln1_scale": torch.ones((n, h), dtype=pd),
            "ln1_bias": torch.zeros((n, h), dtype=pd),
            "qkv_w": stack((h, 3 * h)),
            "qkv_b": torch.zeros((n, 3 * h), dtype=pd),
            "attn_out_w": stack((h, h)),
            "attn_out_b": torch.zeros((n, h), dtype=pd),
            "ln2_scale": torch.ones((n, h), dtype=pd),
            "ln2_bias": torch.zeros((n, h), dtype=pd),
            "mlp_in_w": stack((h, i)),
            "mlp_in_b": torch.zeros((n, i), dtype=pd),
            "mlp_out_w": stack((i, h)),
            "mlp_out_b": torch.zeros((n, h), dtype=pd),
        },
        "ln_f_scale": torch.ones((h,), dtype=pd),
        "ln_f_bias": torch.zeros((h,), dtype=pd),
    }


def param_partition_specs(cfg: DecoderConfig, tp_axis: str = "tp") -> dict:
    """Megatron TP: QKV / MLP-in shard their output features, attn-out /
    MLP-out their input features (one all-reduce each); the tied ``wte``
    shards the vocab, which shards the LM head's logits."""
    t = tp_axis
    return {
        "wte": P(t, None),
        "wpe": P(None, None),
        "layers": {
            "ln1_scale": P(None, None),
            "ln1_bias": P(None, None),
            "qkv_w": P(None, None, t),
            "qkv_b": P(None, t),
            "attn_out_w": P(None, t, None),
            "attn_out_b": P(None, None),
            "ln2_scale": P(None, None),
            "ln2_bias": P(None, None),
            "mlp_in_w": P(None, None, t),
            "mlp_in_b": P(None, t),
            "mlp_out_w": P(None, t, None),
            "mlp_out_b": P(None, None),
        },
        "ln_f_scale": P(None),
        "ln_f_bias": P(None),
    }


# ---- serving-mesh placement ------------------------------------------------
#
# The specs above say WHAT shards over tp; the helpers below bind them to a
# ``(data, fsdp, tp)`` serving mesh (``parallel/mesh.make_serving_mesh``):
# params get the Megatron layout plus an fsdp overlay on whatever tp left
# replicated, and the KV pool (dense or paged, arena included) shards its
# head axis over tp. Divisibility is checked on the host (``MeshShapeError``).


def validate_decoder_mesh(cfg: DecoderConfig, mesh) -> None:
    """Raise a typed ``MeshShapeError`` when ``cfg`` cannot shard over
    ``mesh``'s tp axis: heads, ffn features and vocab must all divide."""
    tp = int(mesh.shape.get(SERVE_TP_AXIS, 1))
    bad = [f"{name}={v}" for name, v in (("heads", cfg.heads),
                                         ("intermediate", cfg.intermediate),
                                         ("vocab_size", cfg.vocab_size)) if v % tp]
    if bad:
        raise mesh_shape_error(
            f"decoder config does not divide the tp axis: {', '.join(bad)} "
            f"% tp={tp} != 0", mesh)


def param_mesh_specs(params: dict, cfg: DecoderConfig, mesh) -> dict:
    """Per-param spec dict for the serving mesh: the Megatron layout with
    the fsdp axis overlaid on each param's first unsharded divisible dim.
    An int8 ``*_scale`` plane takes its payload's spec with the axes it
    does not divide dropped (the size-1 contracted dim replicates, the
    output channels stay with their int8 columns)."""
    fsdp = int(mesh.shape.get(SERVE_FSDP_AXIS, 1))
    specs = param_partition_specs(cfg, tp_axis=SERVE_TP_AXIS)

    def walk(node, sp):
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf, sp[name])
                continue
            if name in sp:
                s = sp[name]
            elif name.endswith("_scale") and name[:-len("_scale")] in sp:
                s = spec_dropping_nondividing(sp[name[:-len("_scale")]], leaf.shape, mesh)
            else:
                raise KeyError(f"no partition spec for decoder param {name!r}")
            out[name] = spec_with_fsdp(s, tuple(leaf.shape), fsdp)
        return out

    return walk(params, specs)


_HEAD_SHARDED = ("k", "v", "k_scale", "v_scale", "kb", "vb", "kb_scale",
                 "vb_scale", "arena_k", "arena_v", "arena_k_scale",
                 "arena_v_scale")


def pool_partition_specs(pool: dict) -> dict:
    """Per-plane specs of a serving pool (dense or paged): the KV planes,
    their int8 scales and the arena shard the head axis over tp; every
    other plane replicates. (JAX's takes the mesh to shard the staged
    logits over the vocab; the port all-gathers the LM head's logits, so
    they replicate.)"""
    head = P(None, None, SERVE_TP_AXIS, None, None)  # (L|A, S|NB|L, nh, ., .)
    return {key: head if key in _HEAD_SHARDED else P() for key in pool}


def shard_decoder_params(params: dict, cfg: DecoderConfig, mesh) -> dict:
    """``params`` placed on the serving mesh with the Megatron + fsdp layout
    (validated first). No-op without a mesh; a one-position mesh moves the
    plain tensors to its device."""
    if mesh is None:
        return params
    validate_decoder_mesh(cfg, mesh)
    return place_pytree(params, mesh, param_mesh_specs(params, cfg, mesh))


def shard_pool(pool: dict, cfg: DecoderConfig, mesh) -> dict:
    """A fresh serving pool placed on the mesh: KV planes head-sharded over
    tp, one contiguous tensor per shard; the other planes stay plain
    (replicated) on the mesh's first device. Pool ops then run per shard.
    The port keeps one copy of each tp shard, so every ``data`` / ``fsdp``
    replica of a tp coordinate must sit on the same device (virtual
    shards); replicas on distinct devices raise ``MeshShapeError``."""
    if mesh is None:
        return pool
    validate_decoder_mesh(cfg, mesh)
    if mesh_is_trivial(mesh):
        return place_pytree(pool, mesh)
    devs = {}
    for p, dev in enumerate(mesh.devices):
        if devs.setdefault(mesh.coords(p)[SERVE_TP_AXIS], dev) != dev:
            raise mesh_shape_error(
                "the serving pool replicates each tp shard over data and fsdp "
                "on one device; replicas on distinct devices are not ported", mesh)
    specs = pool_partition_specs(pool)
    return {key: (ShardedTensor.place(t, mesh, specs[key]) if any(specs[key])
                  else t.to(mesh.devices[0]))
            for key, t in pool.items()}


class _TPParams:
    """Sharded decoder params as one plain dict per tp shard (its column,
    row or vocab slice, every fsdp piece gathered: ZeRO-3's gather on use),
    built once per pool op. Item access reads shard 0 (replicated leaves)."""

    def __init__(self, params: dict):
        self.mesh = tree_mesh(params)
        tp = self.mesh.shape[SERVE_TP_AXIS]
        self.shards = [map_params(
            lambda t, i=i: t.local(SERVE_TP_AXIS, i) if isinstance(t, ShardedTensor) else t,
            params) for i in range(tp)]

    def __getitem__(self, key):
        return self.shards[0][key]

    def __contains__(self, key) -> bool:
        return key in self.shards[0]

    def get(self, key, default=None):
        return self.shards[0].get(key, default)


class _TPLayer(_TPParams):
    """One layer's slices of a :class:`_TPParams`."""

    def __init__(self, shards: list, mesh):
        self.shards, self.mesh = shards, mesh


def _tp(params):
    """The per-tp-shard view of sharded params; anything else unchanged."""
    if isinstance(params, dict) and isinstance(params.get("wte"), ShardedTensor):
        return _TPParams(params)
    return params


def _check_mesh(pool: dict, mesh) -> None:
    """A pool op's ``mesh=`` must be the mesh the pool is sharded on."""
    if not mesh_is_trivial(mesh) and tree_mesh(pool) != mesh:
        raise ValueError("the pool is not sharded on this mesh (shard_pool first)")


def _tp_embed(params: _TPParams, ids):
    """Vocab-parallel embedding: each shard gathers the ids in its vocab
    range (zeros elsewhere), then an all-reduce (exact: one nonzero term)."""
    ids = ids.long()
    parts = []
    for i, sh in enumerate(params.shards):
        w = sh["wte"]
        n = w.shape[0]
        loc = ids.to(w.device) - i * n
        hit = ((loc >= 0) & (loc < n))[..., None]
        loc = loc.clamp(0, n - 1)
        rows = w[loc]
        s = sh.get("wte_scale")
        if s is not None:
            rows = rows.float() * s[loc]
        parts.append(torch.where(hit, rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))
    return all_reduce_sum(parts)


def _tp_row_parallel(parts, lp: _TPLayer, name: str, cfg: DecoderConfig):
    """A row-sharded product: f32 partials per shard, their all-reduce,
    then the int8 per-channel scale once, then the compute dtype."""
    outs = []
    scale = lp.get(name + "_scale")
    for x, sh in zip(parts, lp.shards):
        w = sh[name]
        if scale is None:
            outs.append(torch.matmul(x.float(), w.to(cfg.dtype).float()))
        elif cfg.wq_kernel and x.dim() == 3:
            B, S, K = x.shape
            ones = torch.ones((1, w.shape[-1]), dtype=torch.float32, device=w.device)
            outs.append(wq_matmul(x.reshape(B * S, K).contiguous(), w, ones)
                        .reshape(B, S, w.shape[-1]))
        else:
            outs.append(torch.matmul(x.float(), w.float()))
    out = all_reduce_sum(outs)
    if scale is not None:
        out = out * scale
    return out.to(cfg.dtype)


def _tp_block_qkv(x, lp: _TPLayer, cfg: DecoderConfig):
    """Column-parallel QKV, all-gathered, then split into head-sharded
    (B, nh/tp, S, hd) shards."""
    nh, hd = cfg.heads, cfg.head_dim
    h1 = _ln(x, lp["ln1_scale"], lp["ln1_bias"], cfg.layer_norm_eps).to(cfg.dtype)
    qkv = all_gather([_wq_matmul(h1.to(sh["qkv_w"].device), sh, "qkv_w", cfg)
                      + sh["qkv_b"].to(cfg.dtype) for sh in lp.shards], dim=-1)
    return tuple(split(_split_heads(t, nh, hd), 1, lp.mesh)
                 for t in qkv.split(cfg.hidden, dim=-1))


def _tp_block_finish(x, lp: _TPLayer, ctx: ShardedTensor, cfg: DecoderConfig):
    """:func:`_block_finish` over head-sharded ``ctx``: row-parallel
    attn-out, column-parallel MLP-in, row-parallel MLP-out."""
    B, S, _ = x.shape
    ctx_parts = [c.transpose(1, 2).reshape(B, S, -1) for c in axis_shards(ctx)]
    x = x + _tp_row_parallel(ctx_parts, lp, "attn_out_w", cfg) + lp["attn_out_b"].to(cfg.dtype)
    h2 = _ln(x, lp["ln2_scale"], lp["ln2_bias"], cfg.layer_norm_eps).to(cfg.dtype)
    m_parts = [F.gelu(_wq_matmul(h2.to(sh["mlp_in_w"].device), sh, "mlp_in_w", cfg)
                      + sh["mlp_in_b"].to(cfg.dtype), approximate="tanh")
               for sh in lp.shards]
    x = x + _tp_row_parallel(m_parts, lp, "mlp_out_w", cfg) + lp["mlp_out_b"].to(cfg.dtype)
    return x.to(cfg.dtype)


def _tp_logits(params: _TPParams, h, cfg: DecoderConfig):
    """The vocab-sharded tied LM head over final-LN'd ``h``, logits
    all-gathered."""
    parts = []
    for sh in params.shards:
        w = sh["wte"]
        w = w.float() if w.dtype == torch.int8 else w.to(cfg.dtype).float()
        out = torch.matmul(h.to(cfg.dtype).float().to(w.device), w.t())
        s = sh.get("wte_scale")
        parts.append(out if s is None else out * s[:, 0])
    return all_gather(parts, dim=-1)


def _kv_zeros(params, shape: tuple, dtype, device):
    """Zero KV planes with the head axis at dim 2, head-sharded under TP."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    return split(z, 2, params.mesh) if isinstance(params, _TPParams) else z


def _layer_slices(params: dict, n_layers: int | None = None) -> list[dict]:
    layers = params["layers"]
    n = next(iter(layers.values())).shape[0]
    if n_layers is not None:
        n = min(n, n_layers)
    if isinstance(params, _TPParams):
        return [_TPLayer([{k: v[i] for k, v in sh["layers"].items()}
                          for sh in params.shards], params.mesh) for i in range(n)]
    return [{k: v[i] for k, v in layers.items()} for i in range(n)]


def _device(params: dict) -> torch.device:
    return params["wte"].device


def _ln(x, scale, bias, eps):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _split_heads(x, nh, hd):
    B, S, _ = x.shape
    return x.reshape(B, S, nh, hd).transpose(1, 2)  # (B, nh, S, hd)


def _clamp_start(start: int, width: int, size: int) -> int:
    """``dynamic_update_slice`` semantics: the window start is clamped so
    that ``width`` columns fit in ``size``."""
    return min(max(int(start), 0), size - width)


# ---- int8 KV quantization --------------------------------------------------

_KV_QMAX = 127.0
_KV_SCALE_FLOOR = 1e-8  # all-zero rows (padding) quantize to exact zeros


def _kv_quant(x):
    """Symmetric int8 over the last (head) dim: ``(payload int8, scale f32
    (..., 1))`` with ``x ~= payload * scale``; the round is half to even, as
    ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / _KV_QMAX, min=_KV_SCALE_FLOOR)
    return torch.round(xf / scale).to(torch.int8), scale


def pool_quantized(pool: dict) -> bool:
    return "k_scale" in pool or "kb_scale" in pool


# ---- weight-only int8 ------------------------------------------------------

_WQ_QMAX = 127.0
_WQ_SCALE_FLOOR = 1e-8
_WQ_LAYER_WEIGHTS = ("qkv_w", "attn_out_w", "mlp_in_w", "mlp_out_w")


def _wq_quant(w, axis: int):
    """Symmetric int8 of one weight over its contracted ``axis``: one f32
    scale per output channel, kept with a size-1 dim at ``axis``."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / _WQ_QMAX, min=_WQ_SCALE_FLOOR)
    return torch.round(wf / scale).to(torch.int8), scale


def params_quantized(params: dict) -> bool:
    return "wte_scale" in params


def quantize_params(params: dict, cfg: DecoderConfig) -> dict:
    """int8-quantize wte (per vocab row; the tied LM head with it) and the
    four stacked layer weights (per output channel); everything else gets
    :func:`cast_params_for_inference`. Scales come from the original
    full-precision leaves."""
    out = dict(cast_params_for_inference(params, cfg))
    out["wte"], out["wte_scale"] = _wq_quant(params["wte"], axis=-1)
    layers = dict(out["layers"])
    for name in _WQ_LAYER_WEIGHTS:
        q, s = _wq_quant(params["layers"][name], axis=-2)
        layers[name], layers[name + "_scale"] = q, s
    out["layers"] = layers
    return out


def _wq_matmul(x, lp: dict, name: str, cfg: DecoderConfig):
    """The one weight-product seam: ``x @ lp[name]`` in the compute dtype
    when unquantized; for int8 weights f32 accumulation with the
    per-output-channel scale on the output, through the ``wq_matmul``
    kernel when ``cfg.wq_kernel`` is set."""
    w = lp[name]
    scale = lp.get(name + "_scale")
    if scale is None:
        return torch.matmul(x, w.to(cfg.dtype))
    if cfg.wq_kernel and x.dim() == 3 and w.dim() == 2:
        B, S, K = x.shape
        out = wq_matmul(x.reshape(B * S, K).contiguous(), w, scale.reshape(1, -1))
        return out.reshape(B, S, w.shape[-1]).to(cfg.dtype)
    out = torch.matmul(x.float(), w.float())
    return (out * scale).to(cfg.dtype)


def _tok_embed(params: dict, ids):
    """Token-embedding gather; int8 tables dequantize the gathered rows."""
    if isinstance(params, _TPParams):
        return _tp_embed(params, ids)
    ids = ids.long()
    rows = params["wte"][ids]
    s = params.get("wte_scale")
    if s is None:
        return rows
    return rows.float() * s[ids]


def _pos_embed(params: dict, pos, cfg: DecoderConfig):
    """``wpe[pos]`` with JAX's gather clamp made explicit."""
    return params["wpe"][pos.long().clamp(0, cfg.max_position - 1)]


def _block_qkv(x, lp, cfg: DecoderConfig):
    """Pre-LN + fused QKV projection, head-split: ``(q, k_new, v_new)``
    each (B, nh, S, hd) (head-sharded under TP)."""
    if isinstance(lp, _TPLayer):
        return _tp_block_qkv(x, lp, cfg)
    nh, hd = cfg.heads, cfg.head_dim
    h1 = _ln(x, lp["ln1_scale"], lp["ln1_bias"], cfg.layer_norm_eps)
    qkv = _wq_matmul(h1.to(cfg.dtype), lp, "qkv_w", cfg)
    qkv = qkv + lp["qkv_b"].to(cfg.dtype)
    q, k_new, v_new = qkv.split(cfg.hidden, dim=-1)
    return (_split_heads(q, nh, hd), _split_heads(k_new, nh, hd),
            _split_heads(v_new, nh, hd))


def _attn_ctx(q, k, v, mask_bias, cfg: DecoderConfig, k_scale=None,
              v_scale=None):
    """Dense attention read over already-projected k/v: f32 scores, softmax,
    probabilities rounded to the compute dtype, f32-accumulated probs @ v.
    int8 k/v (with scales) dequantize here."""
    if k_scale is not None:
        k = (k.float() * k_scale).to(cfg.dtype)
        v = (v.float() * v_scale).to(cfg.dtype)
    scores = torch.matmul(q.float(), k.to(cfg.dtype).float().transpose(-1, -2))
    scores = scores / math.sqrt(cfg.head_dim) + mask_bias
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    return torch.matmul(probs.float(), v.to(cfg.dtype).float()).to(cfg.dtype)


def _block_finish(x, lp, ctx, cfg: DecoderConfig):
    """Output projection, residual, MLP. ``ctx`` is (B, nh, S, hd)."""
    if isinstance(lp, _TPLayer):
        return _tp_block_finish(x, lp, ctx, cfg)
    B, S, H = x.shape
    ctx = ctx.transpose(1, 2).reshape(B, S, H)
    attn = _wq_matmul(ctx, lp, "attn_out_w", cfg)
    x = x + attn + lp["attn_out_b"].to(cfg.dtype)
    h2 = _ln(x, lp["ln2_scale"], lp["ln2_bias"], cfg.layer_norm_eps)
    m = _wq_matmul(h2.to(cfg.dtype), lp, "mlp_in_w", cfg)
    m = F.gelu(m + lp["mlp_in_b"].to(cfg.dtype), approximate="tanh")
    m = _wq_matmul(m, lp, "mlp_out_w", cfg)
    x = x + m + lp["mlp_out_b"].to(cfg.dtype)
    return x.to(cfg.dtype)


def _block(x, lp, k, v, mask_bias, cfg: DecoderConfig, k_scale=None,
           v_scale=None, ctx_fn=None, qkv=None):
    """One pre-LN GPT-2 block over already-projected k/v (B, nh, Skv, hd).

    ``ctx_fn(q, k, v, k_scale, v_scale) -> (B, nh, Sq, hd)`` replaces the
    dense :func:`_attn_ctx` read (the flash kernels); it owns scaling and
    masking. ``qkv`` passes this block's own projections when the caller
    already made them (the JAX block recomputes them; the values are the
    same). Returns ``(x, k_new, v_new)``."""
    q, k_new, v_new = qkv if qkv is not None else _block_qkv(x, lp, cfg)
    if ctx_fn is None:
        ctx = _attn_ctx(q, k, v, mask_bias, cfg, k_scale, v_scale)
    else:
        ctx = ctx_fn(q, k, v, k_scale, v_scale).to(cfg.dtype)
    return _block_finish(x, lp, ctx, cfg), k_new, v_new


def _flash_self_ctx(mask):
    """``ctx_fn`` for whole-sequence causal flash attention."""
    mask = mask.to(torch.int32).contiguous()
    return lambda q, k, v, ks, vs: _per_shard(
        flash_attn, q.contiguous(), k.contiguous(), v.contiguous(), mask, causal=True)


def _causal_bias(mask):
    S = mask.shape[1]
    causal = torch.ones((S, S), dtype=torch.bool, device=mask.device).tril()
    allowed = causal[None, None] & (mask[:, None, None, :] > 0)
    return torch.where(allowed, 0.0, -1e9).float()


def _logits(params, x, cfg):
    """Final LN and the tied LM head; f32 logits."""
    h = _ln(x, params["ln_f_scale"], params["ln_f_bias"], cfg.layer_norm_eps)
    if isinstance(params, _TPParams):
        return _tp_logits(params, h, cfg)
    w = params["wte"]
    # int8 values are exact in f32: widen directly, without a bf16 copy
    w = w.float() if w.dtype == torch.int8 else w.to(cfg.dtype).float()
    out = torch.matmul(h.to(cfg.dtype).float(), w.t())
    s = params.get("wte_scale")
    if s is not None:
        out = out * s[:, 0]
    return out


def _prompt_pos(attention_mask, cfg):
    return (torch.cumsum(attention_mask.long(), dim=1) - 1).clamp(min=0)


def forward(params: dict, input_ids, attention_mask, cfg: DecoderConfig, *,
            flash: bool = False):
    """Full causal forward over left- or right-padded ids. Returns logits
    (B, S, V) float32. Positions are ``cumsum(mask) - 1`` (clipped).
    ``flash`` runs attention through ``flash_attn(causal=True)``; fully
    masked query rows then differ (zeros) but never reach live ones."""
    params = _tp(params)
    x = (_tok_embed(params, input_ids)
         + _pos_embed(params, _prompt_pos(attention_mask, cfg), cfg)).to(cfg.dtype)
    ctx_fn = mask_bias = None
    if flash:
        ctx_fn = _flash_self_ctx(attention_mask)
    else:
        mask_bias = _causal_bias(attention_mask)
    for lp in _layer_slices(params):
        qkv = _block_qkv(x, lp, cfg)
        x, _, _ = _block(x, lp, qkv[1], qkv[2], mask_bias, cfg,
                         ctx_fn=ctx_fn, qkv=qkv)
    return _logits(params, x, cfg)


def prefill(params: dict, input_ids, attention_mask, cfg: DecoderConfig,
            cache_len: int, *, flash: bool = False):
    """Causal forward over the (left-padded) prompt. Returns
    ``(last_logits (B, V), cache)`` with K/V (L, B, nh, cache_len, hd) in
    the compute dtype, zero past the prompt."""
    params = _tp(params)
    B, S = input_ids.shape
    assert cache_len >= S
    x = (_tok_embed(params, input_ids)
         + _pos_embed(params, _prompt_pos(attention_mask, cfg), cfg)).to(cfg.dtype)
    ctx_fn = mask_bias = None
    if flash:
        ctx_fn = _flash_self_ctx(attention_mask)
    else:
        mask_bias = _causal_bias(attention_mask)
    lps = _layer_slices(params)
    shape = (len(lps), B, cfg.heads, cache_len, cfg.head_dim)
    cache = {"k": _kv_zeros(params, shape, cfg.dtype, x.device),
             "v": _kv_zeros(params, shape, cfg.dtype, x.device)}
    for i, lp in enumerate(lps):
        qkv = _block_qkv(x, lp, cfg)
        cache["k"][i, :, :, :S] = qkv[1]
        cache["v"][i, :, :, :S] = qkv[2]
        x, _, _ = _block(x, lp, qkv[1], qkv[2], mask_bias, cfg,
                         ctx_fn=ctx_fn, qkv=qkv)
    return _logits(params, x[:, -1:, :], cfg)[:, 0, :], cache


def decode_step(params: dict, token, step_pos, slot: int, slot_mask,
                cache: dict, cfg: DecoderConfig, n_layers: int | None = None):
    """One decode step. ``token`` (B,), ``step_pos`` (B,) position ids,
    ``slot`` the cache column to write, ``slot_mask`` (B, cache_len) live
    columns INCLUDING the one written. Returns ``(logits (B, V), cache)``;
    the cache is updated in place. ``n_layers`` runs only the first N
    blocks (plus the final LN and head); deeper layers' KV is untouched."""
    params = _tp(params)
    C = cache["k"].shape[3]
    slot = _clamp_start(slot, 1, C)
    x = (_tok_embed(params, token)[:, None, :]
         + _pos_embed(params, step_pos, cfg)[:, None, :]).to(cfg.dtype)
    mask_bias = torch.where(slot_mask[:, None, None, :] > 0, 0.0, -1e9).float()
    for i, lp in enumerate(_layer_slices(params, n_layers)):
        qkv = _block_qkv(x, lp, cfg)
        cache["k"][i, :, :, slot] = qkv[1][:, :, 0]
        cache["v"][i, :, :, slot] = qkv[2][:, :, 0]
        x, _, _ = _block(x, lp, cache["k"][i], cache["v"][i], mask_bias, cfg,
                         qkv=qkv)
    return _logits(params, x, cfg)[:, 0, :], cache


def _filter_logits(logits, top_k: int | None, top_p: float | None):
    """top-k then top-p masking to -inf (HF composition), static shapes."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cut = cum - probs > top_p
        cutoff = torch.where(cut, math.inf, sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -math.inf, logits)
    return logits


def _sample_fn(temperature: float, top_k: int | None, top_p: float | None):
    """``sample(logits, generator) -> (B,) int32``: greedy argmax at
    temperature 0 (the generator is not used), else temperature first,
    then the top-k / top-p filter, then a categorical draw."""
    def sample(logits, generator):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        lg = _filter_logits(logits / temperature, top_k, top_p)
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    return sample


def generate(params: dict, prompt_ids, attention_mask, cfg: DecoderConfig,
             max_new: int, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             eos_id: int | None = None, top_k: int | None = None,
             top_p: float | None = None):
    """Generate ``max_new`` tokens after a LEFT-padded prompt batch.
    Returns (B, max_new) int32; positions after a row's EOS hold
    ``eos_id``. With ``eos_id`` the loop stops once every row is done (one
    host read per step). ``generator`` drives sampling when
    ``temperature > 0``; greedy ignores it."""
    B, S = prompt_ids.shape
    if S + max_new > cfg.max_position:
        raise ValueError(
            f"prompt ({S}) + max_new ({max_new}) exceeds max_position "
            f"({cfg.max_position})"
        )
    params = _tp(params)
    dev = prompt_ids.device
    logits, cache = prefill(params, prompt_ids, attention_mask, cfg, S + max_new)
    n_prompt = attention_mask.long().sum(dim=1)
    slot_mask = torch.cat(
        [attention_mask.to(torch.int32),
         torch.zeros((B, max_new), dtype=torch.int32, device=dev)], dim=1)
    sample = _sample_fn(temperature, top_k, top_p)
    if eos_id is None:
        toks = torch.empty((B, max_new), dtype=torch.int32, device=dev)
    else:
        toks = torch.full((B, max_new), eos_id, dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(max_new):
        tok = sample(logits, generator)
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        toks[:, t] = tok
        if t == max_new - 1 or (eos_id is not None and bool(done.all())):
            break
        slot_mask[:, S + t] = 1
        logits, cache = decode_step(params, tok, n_prompt + t, S + t,
                                    slot_mask, cache, cfg)
    return toks


def cast_params_for_inference(params: dict, cfg: DecoderConfig) -> dict:
    """Weights in the compute dtype; layernorm leaves stay f32. f32 configs
    pass through unchanged."""
    if cfg.dtype == torch.float32:
        return params
    ln = {f"{a}_{b}" for a in ("ln1", "ln2", "ln_f") for b in ("scale", "bias")}

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ln or v.dtype != torch.float32:
                out[k] = v
            else:
                out[k] = v.to(cfg.dtype)
        return out

    return walk(params)


# ---- continuous-batching slot pool (dense) ---------------------------------


def pool_init(params: dict, cfg: DecoderConfig, n_slots: int, cache_len: int,
              kv_quant: bool = False, arena_blocks: int = 0,
              arena_block: int = 0) -> dict:
    """Empty dense serving pool on the params' device: per-slot KV rows
    (L, n_slots, nh, cache_len, hd), staged logits, slot masks and cursors;
    int8 KV adds f32 scale planes (the ``k_scale`` key is the format
    marker).

    With ``arena_blocks > 0`` the pool also carries the prefix cache's KV
    arena, ``arena_blocks`` blocks of ``arena_block`` tokens shaped
    ``(n, L, nh, block, hd)`` (block-major, so :func:`kv_extract` /
    :func:`kv_insert` move whole blocks with one indexed op), in the KV
    dtype, with f32 scale planes under int8 KV. Which block holds which
    prefix is host state (``engine/prefix_cache.PrefixCache``)."""
    L, nh, hd = cfg.layers, cfg.heads, cfg.head_dim
    dev = _device(params)
    kv_dtype = torch.int8 if kv_quant else cfg.dtype

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    pool = {
        "k": z((L, n_slots, nh, cache_len, hd), kv_dtype),
        "v": z((L, n_slots, nh, cache_len, hd), kv_dtype),
        "logits": z((n_slots, cfg.vocab_size), torch.float32),
        "slot_mask": z((n_slots, cache_len), torch.int32),
        "pos": z((n_slots,), torch.int32),
        "write": z((n_slots,), torch.int32),
    }
    if kv_quant:
        pool["k_scale"] = z((L, n_slots, nh, cache_len, 1), torch.float32)
        pool["v_scale"] = z((L, n_slots, nh, cache_len, 1), torch.float32)
    if arena_blocks > 0:
        shape = (arena_blocks, L, nh, arena_block)
        pool["arena_k"] = z(shape + (hd,), kv_dtype)
        pool["arena_v"] = z(shape + (hd,), kv_dtype)
        if kv_quant:
            pool["arena_k_scale"] = z(shape + (1,), torch.float32)
            pool["arena_v_scale"] = z(shape + (1,), torch.float32)
    return pool


def _store_kv(pool, cache, rows, quant):
    """Write prefill caches (L, M, nh, C, hd) into pool rows ``rows``."""
    if quant:
        ck, sk = _kv_quant(cache["k"])
        cv, sv = _kv_quant(cache["v"])
        pool["k_scale"][:, rows] = sk
        pool["v_scale"][:, rows] = sv
    else:
        ck, cv = cache["k"], cache["v"]
    pool["k"][:, rows] = ck.to(pool["k"].dtype)
    pool["v"][:, rows] = cv.to(pool["v"].dtype)


def pool_admit(params: dict, ids, mask, pool: dict, slot: int,
               cfg: DecoderConfig, *, flash: bool = False, mesh=None) -> dict:
    """Prefill ONE left-padded prompt (``ids``/``mask`` (1, S)) into
    ``slot``: KV written, cursors set, first-token logits staged. Paged
    pools run the same over a gathered dense view and scatter it back.
    ``mesh`` names the mesh a sharded pool lives on (checked)."""
    _check_mesh(pool, mesh)
    params = _tp(params)
    if pool_paged(pool):
        view = _paged_gather(pool)
        return _paged_scatter(pool, pool_admit(params, ids, mask, view, slot,
                                               cfg, flash=flash))
    return pool_admit_batch(params, ids, mask, pool, [slot], cfg, flash=flash)


def pool_admit_batch(params: dict, ids, mask, pool: dict, slots,
                     cfg: DecoderConfig, *, flash: bool = False, mesh=None) -> dict:
    """Prefill M left-padded prompts (M, S) into M distinct ``slots`` in one
    batched forward; row-wise identical to M :func:`pool_admit` calls."""
    _check_mesh(pool, mesh)
    params = _tp(params)
    if pool_paged(pool):
        view = _paged_gather(pool)
        return _paged_scatter(pool, pool_admit_batch(params, ids, mask, view,
                                                     slots, cfg, flash=flash))
    C = pool["k"].shape[3]
    M, S = ids.shape
    rows = to_device(slots, pool["k"].device, torch.long)
    last_logits, cache = prefill(params, ids, mask, cfg, cache_len=C,
                                 flash=flash)
    _store_kv(pool, cache, rows, pool_quantized(pool))
    row_mask = torch.zeros((M, C), dtype=torch.int32, device=ids.device)
    row_mask[:, :S] = mask.to(torch.int32)
    pool["slot_mask"][rows] = row_mask
    pool["logits"][rows] = last_logits
    pool["pos"][rows] = mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    pool["write"][rows] = S
    return pool


def pool_prefill_chunk(params: dict, ids, mask, pos, pool: dict, slot: int,
                       start: int, n_prompt, cfg: DecoderConfig, *,
                       first: bool, last: bool, last_col: int | None = None,
                       flash: bool = False, mesh=None) -> dict:
    """CHUNKED prefill: write one piece (``ids``/``mask``/``pos`` (1, T)) of
    a prompt into ``slot``'s cache at ``[start, start + T)`` and attend it
    against the row (query t sees ``live & (col <= start + t)``).
    ``first`` clears the stale mask row; ``last`` stages the next-token
    logits (from piece column ``last_col``, default the last) and the
    cursors (``n_prompt`` real tokens, write at ``start + T``).

    The write window clamps like ``dynamic_update_slice``; the attention
    predicate uses ``start`` as given, as in JAX. A paged pool writes the
    piece straight into the slot's blocks and reads the slot's table row
    (``flash_chunk_attn_paged``, or a gather of that one row), never the
    whole pool; the sentinel block is never written."""
    _check_mesh(pool, mesh)
    params = _tp(params)
    paged = pool_paged(pool)
    C = pool["slot_mask"].shape[1]
    T = ids.shape[1]
    st = _clamp_start(start, T, C)
    x = (_tok_embed(params, ids) + _pos_embed(params, pos, cfg)).to(cfg.dtype)
    if first:
        row_mask = torch.zeros((C,), dtype=torch.int32, device=ids.device)
    else:
        row_mask = pool["slot_mask"][slot].clone()
    row_mask[st:st + T] = mask[0].to(torch.int32)
    pool["slot_mask"][slot] = row_mask
    quant = pool_quantized(pool)
    if not flash:
        idxs = torch.arange(C, device=ids.device)[None, None, None, :]
        qpos = (int(start) + torch.arange(T, device=ids.device))[None, None, :, None]
        allowed = (row_mask[None, None, None, :] > 0) & (idxs <= qpos)
        mask_bias = torch.where(allowed, 0.0, -1e9).float()
    if paged:
        tbl_row = pool["block_tbl"][slot]
        Bk = paged_block(pool)
        cols = torch.arange(st, st + T, device=ids.device)
        dst_b = tbl_row[cols // Bk].long()
        dst_c = cols % Bk
        keep = (dst_b > 0)[:, None, None]
    for i, lp in enumerate(_layer_slices(params)):
        q, k_new, v_new = _block_qkv(x, lp, cfg)  # (1, nh, T, hd)
        kn, vn = k_new[0], v_new[0]
        if quant:
            kn, sk = _kv_quant(kn)
            vn, sv = _kv_quant(vn)
        if paged:
            kb, vb = pool["kb"][i], pool["vb"][i]
            writes = [(kb, kn), (vb, vn)]
            if quant:
                writes += [(pool["kb_scale"][i], sk), (pool["vb_scale"][i], sv)]
            for plane, new in writes:
                # (T, nh, d) at (block, :, column); sentinel targets keep
                # their bytes
                new = new.transpose(0, 1).to(plane.dtype)
                plane[dst_b, :, dst_c] = torch.where(
                    keep, new, plane[dst_b, :, dst_c])
            kbs = pool["kb_scale"][i] if quant else None
            vbs = pool["vb_scale"][i] if quant else None
            if flash:
                ctx = _per_shard(flash_chunk_attn_paged, q[0].contiguous(), kb, vb,
                                 kbs, vbs, tbl_row, row_mask, start)[None]
            else:
                row = tbl_row[None]
                ctx = _attn_ctx(q, _per_shard(gather_rows, kb, row),
                                _per_shard(gather_rows, vb, row), mask_bias, cfg,
                                _per_shard(gather_rows, kbs, row) if quant else None,
                                _per_shard(gather_rows, vbs, row) if quant else None)
        else:
            k_row, v_row = pool["k"][i, slot], pool["v"][i, slot]
            k_row[:, st:st + T] = kn.to(k_row.dtype)
            v_row[:, st:st + T] = vn.to(v_row.dtype)
            ks_row = vs_row = None
            if quant:
                ks_row, vs_row = pool["k_scale"][i, slot], pool["v_scale"][i, slot]
                ks_row[:, st:st + T] = sk
                vs_row[:, st:st + T] = sv
            if flash:
                ctx = _per_shard(flash_chunk_attn, q[0].contiguous(), k_row, v_row,
                                 row_mask, start, k_scale=ks_row, v_scale=vs_row)[None]
            else:
                ctx = _attn_ctx(q, k_row[None], v_row[None], mask_bias, cfg,
                                None if ks_row is None else ks_row[None],
                                None if vs_row is None else vs_row[None])
        x = _block_finish(x, lp, ctx.to(cfg.dtype), cfg)
    if last:
        lc = T - 1 if last_col is None else min(max(int(last_col), 0), T - 1)
        pool["logits"][slot] = _logits(params, x[:, lc:lc + 1, :], cfg)[0, 0]
        pool["pos"][slot] = int(n_prompt)
        pool["write"][slot] = int(start) + T
    return pool


def _decode_loop(params, pool, active, generator, cfg, n_steps, sample,
                 prep, attend_layer):
    """The decode-chunk body shared by the dense and the paged-kernel
    paths. Per step, ``prep(w, slot_mask)`` builds what every layer needs
    (write targets, masks); ``attend_layer(i, lp, x, step)`` writes layer
    ``i``'s new KV for active lanes and returns the next ``x``."""
    B, C = pool["slot_mask"].shape
    dev = pool["slot_mask"].device
    active = to_device(active, dev).bool()
    act_i = active.to(torch.int32)
    cols = torch.arange(C, device=dev)[None, :]
    lps = _layer_slices(params)
    logits, slot_mask = pool["logits"], pool["slot_mask"]
    pos, write = pool["pos"], pool["write"]
    toks = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
    for t in range(n_steps):
        tok = sample(logits, generator)
        w = write.clamp(max=C - 1)
        # the sampled token's own cache column attends to itself
        slot_mask = torch.where(active[:, None] & (cols == w[:, None]), 1, slot_mask)
        x = (_tok_embed(params, tok)[:, None, :]
             + _pos_embed(params, pos, cfg)[:, None, :]).to(cfg.dtype)
        step = prep(w.long(), slot_mask)
        for i, lp in enumerate(lps):
            x = attend_layer(i, lp, x, step)
        new_logits = _logits(params, x, cfg)[:, 0, :]
        logits = torch.where(active[:, None], new_logits, logits)
        pos = pos + act_i
        write = write + act_i
        toks[t] = tok
    pool.update(logits=logits, slot_mask=slot_mask, pos=pos, write=write)
    return pool, toks


def _write_lanes(plane, idx, new, act_b):
    """``plane[idx] = new`` for active lanes; inactive lanes write their old
    bytes back (no host read of ``active``)."""
    plane[idx] = torch.where(act_b, new.to(plane.dtype), plane[idx])


_DENSE_KV = ("k", "v", "k_scale", "v_scale")


def _write_kv(pool, names, i, idx, kn, vn, act_b, quant):
    """Write one layer's new K/V (and int8 scales) at ``idx``; returns the
    layer's (k, v, k_scale, v_scale) planes."""
    k, v, ks, vs = (pool[n][i] if n in pool else None for n in names)
    if quant:
        kn, sk = _kv_quant(kn)
        vn, sv = _kv_quant(vn)
        _write_lanes(ks, idx, sk, act_b)
        _write_lanes(vs, idx, sv, act_b)
    _write_lanes(k, idx, kn, act_b)
    _write_lanes(v, idx, vn, act_b)
    return k, v, ks, vs


def pool_decode_chunk(params: dict, pool: dict, active, generator,
                      cfg: DecoderConfig, n_steps: int,
                      temperature: float = 0.0, top_k: int | None = None,
                      top_p: float | None = None,
                      paged_kernel: bool = False, mesh=None):
    """Advance every ``active`` slot ``n_steps`` decode steps. Returns
    ``(pool, tokens (n_steps, n_slots) int32)`` on the pool's device;
    inactive lanes compute but do not advance. Paged pools gather, run the
    dense chunk and scatter back, unless ``paged_kernel`` is set: then the
    chunk runs on the block planes through ``paged_attn_decode`` (once per
    tp shard on a sharded pool)."""
    _check_mesh(pool, mesh)
    params = _tp(params)
    if pool_paged(pool):
        if paged_kernel:
            return _paged_decode_chunk_kernel(params, pool, active, generator,
                                              cfg, n_steps, temperature,
                                              top_k, top_p)
        view, toks = pool_decode_chunk(params, _paged_gather(pool), active,
                                       generator, cfg, n_steps, temperature,
                                       top_k, top_p)
        return _paged_scatter(pool, view), toks
    B = pool["logits"].shape[0]
    dev = pool["k"].device
    b_idx = torch.arange(B, device=dev)
    act_b = to_device(active, dev).bool()[:, None, None]
    quant = pool_quantized(pool)

    def prep(w, slot_mask):
        bias = torch.where(slot_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        return (b_idx, slice(None), w, slice(None)), bias

    def attend_layer(i, lp, x, step):
        idx, mask_bias = step
        q, k_new, v_new = _block_qkv(x, lp, cfg)  # (B, nh, 1, hd)
        kl, vl, ks, vs = _write_kv(pool, _DENSE_KV, i, idx, k_new[:, :, 0],
                                   v_new[:, :, 0], act_b, quant)
        x, _, _ = _block(x, lp, kl, vl, mask_bias, cfg, k_scale=ks,
                         v_scale=vs, qkv=(q, k_new, v_new))
        return x

    return _decode_loop(params, pool, active, generator, cfg, n_steps,
                        _sample_fn(temperature, top_k, top_p), prep,
                        attend_layer)


def _paged_decode_chunk_kernel(params, pool, active, generator, cfg, n_steps,
                               temperature, top_k, top_p):
    """:func:`pool_decode_chunk` directly on the paged block planes: each
    step writes the new token's KV into its slot's current physical block
    and reads attention through ``paged_attn_decode`` (one launch per
    layer per step)."""
    B = pool["slot_mask"].shape[0]
    dev = pool["kb"].device
    Bk = paged_block(pool)
    tbl = pool["block_tbl"]
    b_idx = torch.arange(B, device=dev)
    act_b = to_device(active, dev).bool()[:, None, None]
    quant = pool_quantized(pool)
    names = ("kb", "vb", "kb_scale", "vb_scale")

    def prep(w, slot_mask):
        # each lane's write column in physical coordinates; inactive lanes
        # write their old bytes back, so duplicate targets (the sentinel)
        # always receive identical values
        return (tbl[b_idx, w // Bk].long(), slice(None), w % Bk, slice(None)), slot_mask

    def attend_layer(i, lp, x, step):
        idx, slot_mask = step
        q, k_new, v_new = _block_qkv(x, lp, cfg)
        kbl, vbl, kbs, vbs = _write_kv(pool, names, i, idx, k_new[:, :, 0],
                                       v_new[:, :, 0], act_b, quant)
        ctx = _per_shard(paged_attn_decode, q[:, :, 0, :].contiguous(), kbl, vbl,
                         kbs, vbs, tbl, slot_mask)
        return _block_finish(x, lp, ctx[:, :, None, :], cfg)

    return _decode_loop(params, pool, active, generator, cfg, n_steps,
                        _sample_fn(temperature, top_k, top_p), prep,
                        attend_layer)


# ---- self-speculative decoding ---------------------------------------------
#
# The first D layers of the same model draft k greedy tokens against a
# depth-prefix of the slot pool's KV; one full-model pass then scores all
# k+1 positions at once, and the longest draft prefix matching the full
# model's argmaxes is accepted. Acceptance compares argmaxes, so the
# emitted stream is plain greedy decode's by construction (greedy only).

def _draft_scan(params, cfg: DecoderConfig, planes: dict, slot_mask, pos, w,
                t0, active, n_draft: int):
    """``n_draft`` greedy draft steps over a DEPTH-PREFIX KV stack.

    ``planes`` holds the first D layers' ``k`` / ``v`` (and under int8 KV
    ``k_scale`` / ``v_scale``), each (D, B, nh, C, d); the steps write them
    IN PLACE. From certain token ``t0`` at cache column ``w`` / position
    ``pos``, step j writes the fed token's shallow KV at column
    ``min(w + j, C - 1)`` (active lanes only), attends the live cache plus
    this cycle's columns ``w..col``, and predicts the next token from the
    final LN and tied head over the truncated stack. Returns the drafts
    d_1..d_k, (B, n_draft) int32."""
    D_ = planes["k"].shape[0]
    B, C = t0.shape[0], planes["k"].shape[3]
    dev = t0.device
    b_idx = torch.arange(B, device=dev)
    act_b = active[:, None, None]
    idxs = torch.arange(C, device=dev)[None, :]
    quant = "k_scale" in planes
    lps = _layer_slices(params, D_)
    drafts = torch.empty((B, n_draft), dtype=torch.int32, device=dev)
    tok = t0
    for j in range(n_draft):
        col = (w + j).clamp(max=C - 1)
        x = (_tok_embed(params, tok)[:, None, :]
             + _pos_embed(params, pos + j, cfg)[:, None, :]).to(cfg.dtype)
        allowed = (slot_mask > 0) | ((idxs >= w[:, None]) & (idxs <= col[:, None]))
        mask_bias = torch.where(allowed, 0.0, -1e9).float()[:, None, None, :]
        idx = (b_idx, slice(None), col.long(), slice(None))
        for i, lp in enumerate(lps):
            q, k_new, v_new = _block_qkv(x, lp, cfg)  # (B, nh, 1, hd)
            kl, vl, ks, vs = _write_kv(planes, _DENSE_KV, i, idx, k_new[:, :, 0],
                                       v_new[:, :, 0], act_b, quant)
            x, _, _ = _block(x, lp, kl, vl, mask_bias, cfg, k_scale=ks,
                             v_scale=vs, qkv=(q, k_new, v_new))
        tok = torch.argmax(_logits(params, x, cfg)[:, 0, :], dim=-1).to(torch.int32)
        drafts[:, j] = tok
    return drafts


def pool_decode_draft(params: dict, pool: dict, active, cfg: DecoderConfig, *,
                      draft_layers: int, n_draft: int):
    """Draft ``n_draft`` greedy tokens per active lane with the first
    ``draft_layers`` layers; returns (B, n_draft) int32. Pure with respect
    to the pool: the draft writes into copies of the depth-prefix planes.
    A standalone probe of draft quality; serving runs the fused
    :func:`pool_decode_spec`. Paged pools draft over a gathered view."""
    params = _tp(params)
    if pool_paged(pool):
        return pool_decode_draft(params, _paged_gather(pool), active, cfg,
                                 draft_layers=draft_layers, n_draft=n_draft)
    C = pool["k"].shape[3]
    active = to_device(active, pool["k"].device).bool()
    t0 = torch.argmax(pool["logits"], dim=-1).to(torch.int32)
    w = pool["write"].clamp(max=C - n_draft)
    planes = {n: pool[n][:draft_layers].clone() for n in _DENSE_KV if n in pool}
    return _draft_scan(params, cfg, planes, pool["slot_mask"], pool["pos"], w,
                       t0, active, n_draft)


def pool_decode_spec(params: dict, pool: dict, active, cfg: DecoderConfig,
                     n_cycles: int, *, draft_layers: int, n_spec: int):
    """``n_cycles`` draft / verify / accept cycles over every active lane in
    one call: the speculative counterpart of :func:`pool_decode_chunk`
    (greedy only).

    Per cycle: the staged logits' argmax is the certain token t0; the first
    ``draft_layers`` layers draft ``n_spec`` = k tokens; one full-model
    pass embeds ``[t0, d_1..d_k]`` at positions ``pos + 0..k``, writes
    their K/V at columns ``w..w+k`` (``w = min(write, C - 1 - k)``), and
    query i attends the live cache plus ``w..w+i``. ``acc`` drafts are
    accepted (the longest prefix equal to the full model's argmaxes); the
    lane emits ``acc + 1`` tokens, its staged logits become the verify
    logits at position ``acc``, and columns ``w..w+acc`` turn live. The
    rejected tail stays masked: the rewind is a mask, not a copy. Inactive
    lanes compute, write back their old bytes, and do not advance.

    The draft writes the pool's own depth-prefix planes in place: verify
    rewrites every column a draft wrote (columns ``w..w+k-1``) in every
    layer for active lanes, and inactive lanes write back the bytes they
    read, so the pool ends as if the draft had worked on copies.

    Returns ``(pool, toks (n_cycles, B, k+1) int32, n_emit (n_cycles, B)
    int32)``: a lane's stream is each cycle's first ``n_emit`` tokens.
    Paged pools gather, run and scatter back; the scatter skips the
    sentinel and shared prefix blocks, which verify never writes."""
    params = _tp(params)
    if pool_paged(pool):
        view, toks, n_emit = pool_decode_spec(params, _paged_gather(pool), active,
                                              cfg, n_cycles,
                                              draft_layers=draft_layers, n_spec=n_spec)
        return _paged_scatter(pool, view), toks, n_emit
    B, C = pool["slot_mask"].shape
    dev = pool["k"].device
    k = n_spec
    active = to_device(active, dev).bool()
    quant = pool_quantized(pool)
    b_idx = torch.arange(B, device=dev)
    idxs = torch.arange(C, device=dev)
    offs = torch.arange(k + 1, device=dev)
    act_bt = active[:, None, None, None]
    lps = _layer_slices(params)
    draft = {n: pool[n][:draft_layers] for n in _DENSE_KV if n in pool}
    logits, slot_mask = pool["logits"], pool["slot_mask"]
    pos, write = pool["pos"], pool["write"]
    toks = torch.empty((n_cycles, B, k + 1), dtype=torch.int32, device=dev)
    n_emit = torch.empty((n_cycles, B), dtype=torch.int32, device=dev)
    for c in range(n_cycles):
        w = write.clamp(max=C - 1 - k)
        t0 = torch.argmax(logits, dim=-1).to(torch.int32)
        drafts = _draft_scan(params, cfg, draft, slot_mask, pos, w, t0, active, k)
        u = torch.cat([t0[:, None], drafts], dim=1)  # (B, k+1)
        x = (_tok_embed(params, u)
             + _pos_embed(params, pos[:, None] + offs[None, :], cfg)).to(cfg.dtype)
        qcol = w[:, None] + offs[None, :]  # (B, k+1) each query's column
        allowed = (slot_mask[:, None, :] > 0) | (
            (idxs[None, None, :] >= w[:, None, None])
            & (idxs[None, None, :] <= qcol[:, :, None]))
        mask_bias = torch.where(allowed, 0.0, -1e9).float()[:, None]
        # (b, column) pairs: each lane's k+1 rows land at its own columns,
        # (B, k+1, nh, d) as in JAX
        idx = (b_idx[:, None], slice(None), qcol.long(), slice(None))
        for i, lp in enumerate(lps):
            q, k_new, v_new = _block_qkv(x, lp, cfg)  # (B, nh, k+1, hd)
            kl, vl, ks, vs = _write_kv(pool, _DENSE_KV, i, idx, k_new.transpose(1, 2),
                                       v_new.transpose(1, 2), act_bt, quant)
            x, _, _ = _block(x, lp, kl, vl, mask_bias, cfg, k_scale=ks,
                             v_scale=vs, qkv=(q, k_new, v_new))
        out_logits = _logits(params, x, cfg)  # (B, k+1, V)
        g = torch.argmax(out_logits, dim=-1).to(torch.int32)
        # g[:, i] is the true next token after u_0..u_i
        acc = torch.cumprod((drafts == g[:, :k]).to(torch.int32), dim=1).sum(dim=1)
        emit = torch.where(active, acc + 1, 0).to(torch.int32)
        logits = torch.where(active[:, None], out_logits[b_idx, acc], logits)
        live = ((idxs[None, :] >= w[:, None]) & (idxs[None, :] <= (w + acc)[:, None])
                & active[:, None])
        slot_mask = torch.where(live, 1, slot_mask)
        pos = pos + emit
        write = write + emit
        toks[c] = u
        n_emit[c] = emit
    pool.update(logits=logits, slot_mask=slot_mask, pos=pos, write=write)
    return pool, toks, n_emit


# ---- paged block-table KV store --------------------------------------------
#
# One global pool of fixed-size KV blocks plus a per-slot block table: slot
# s's logical column c lives at block ``block_tbl[s, c // block]``, column
# ``c % block``. Block 0 is a SENTINEL: never allocated; every unallocated
# table entry points at it. Which blocks a slot owns is host state
# (:class:`BlockAllocator`).


class PagedPoolOOM(RuntimeError):
    """Typed allocation failure of the paged KV pool, raised on the host
    before anything is written."""

    def __init__(self, want: int, free: int):
        super().__init__(f"paged KV pool exhausted: need {want} blocks, {free} free")
        self.want = want
        self.free = free


class BlockAllocator:
    """Host-side free list and refcounts over the paged pool's blocks.

    Ids are in ``[1, n_blocks)`` (0 is the sentinel). ``alloc`` is
    all-or-nothing (raises :class:`PagedPoolOOM`), ``pin`` adds a reference
    to a live block, ``release`` drops one per id and frees a block when
    its count reaches zero. Low ids allocate first."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("paged pool needs >= 2 blocks (one sentinel)")
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._refs: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise PagedPoolOOM(n, len(self._free))
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        return ids

    def pin(self, ids) -> None:
        for i in ids:
            if i not in self._refs:
                raise ValueError(f"pin of unallocated block {i}")
            self._refs[i] += 1

    def release(self, ids) -> int:
        freed = 0
        for i in ids:
            r = self._refs.get(i, 0) - 1
            if r > 0:
                self._refs[i] = r
            elif r == 0:
                del self._refs[i]
                self._free.append(i)
                freed += 1
            else:
                raise ValueError(f"release of unallocated block {i}")
        return freed

    def stats(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "free": self.n_free,
            "allocated": self.n_allocated,
            "shared": sum(1 for r in self._refs.values() if r > 1),
        }


_PAGED_KEYS = ("kb", "vb", "kb_scale", "vb_scale", "block_tbl")


def pool_paged(pool: dict) -> bool:
    return "block_tbl" in pool


def paged_block(pool: dict) -> int:
    return pool["kb"].shape[3]


# HBM ledger component -> pool keys it accounts (both layouts; absent keys
# skip), the JAX package's table
_HBM_COMPONENT_KEYS = {
    "slot_pool": ("k", "v"),
    "kv_blocks": ("kb", "vb"),
    "kv_scales": ("k_scale", "v_scale", "kb_scale", "vb_scale"),
    "block_table": ("block_tbl",),
    "prefix_arena": ("arena_k", "arena_v"),
    "arena_scales": ("arena_k_scale", "arena_v_scale"),
}


def _device_key(t: torch.Tensor) -> str:
    """The HBM ledger's device label: the CUDA index, "0" on the CPU (the
    JAX package's single-device label)."""
    return str(t.device.index or 0) if t.is_cuda else "0"


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    else:
        yield tree


def params_device_bytes(params: dict) -> dict[str, int]:
    """Param bytes per device (int8 payloads and their scales included):
    the ``weights.*`` HBM ledger's source. Sharded params are keyed by mesh
    position ("0".."n-1"; virtual shards may share one card)."""
    if tree_mesh(params) is not None:
        return tree_position_bytes(params)
    out: dict[str, int] = {}
    for t in _tensor_leaves(params):
        dev = _device_key(t)
        out[dev] = out.get(dev, 0) + t.numel() * t.element_size()
    return out


def pool_component_device_bytes(pool: dict) -> dict[str, dict[str, int]]:
    """Device bytes of the pool's KV storage per ledger component and
    device: ``{component: {device: bytes}}``. A dense pool reports
    ``slot_pool``, ``kv_scales`` and ``prefix_arena`` (+ ``arena_scales``);
    a paged one ``kv_blocks``, ``kv_scales`` and ``block_table``. A sharded
    pool is keyed by mesh position: a head-sharded plane charges each
    position its shard (1/tp), a replicated one (the block table) every
    position in full."""
    mesh = tree_mesh(pool)
    out: dict[str, dict[str, int]] = {}
    for component, keys in _HBM_COMPONENT_KEYS.items():
        planes = {c: pool[c] for c in keys if c in pool}
        if mesh is not None:
            per_dev = tree_position_bytes(planes, mesh)
        else:
            per_dev = {}
            for t in planes.values():
                dev = _device_key(t)
                per_dev[dev] = per_dev.get(dev, 0) + t.numel() * t.element_size()
        if any(per_dev.values()):
            out[component] = per_dev
    return out


def pool_component_bytes(pool: dict) -> dict[str, int]:
    """Bytes of each ledger component's planes, whole (a sharded plane's
    shards summed once)."""
    out = {}
    for component, keys in _HBM_COMPONENT_KEYS.items():
        n = sum(pool[c].numel() * pool[c].element_size() for c in keys if c in pool)
        if n:
            out[component] = n
    return out


def pool_bytes(pool: dict) -> int:
    """Device bytes of the pool's KV storage: caches, prefix arena and int8
    scales of a dense pool; block planes, scales and table of a paged one
    (the sum of :func:`pool_component_bytes`)."""
    return sum(pool_component_bytes(pool).values())


def paged_pool_init(params: dict, cfg: DecoderConfig, n_slots: int,
                    cache_len: int, n_blocks: int, block: int,
                    kv_quant: bool = False) -> dict:
    """Empty PAGED pool: ``n_blocks`` blocks of ``block`` tokens (block 0 the
    sentinel) and an ``(n_slots, cache_len // block)`` table, beside the
    dense pool's logits / mask / cursor planes."""
    if cache_len % block != 0:
        raise ValueError(
            f"cache_len ({cache_len}) must be a multiple of the paged block "
            f"size ({block})"
        )
    if n_blocks < 2:
        raise ValueError("paged pool needs >= 2 blocks (one sentinel)")
    L, nh, hd = cfg.layers, cfg.heads, cfg.head_dim
    dev = _device(params)
    kv_dtype = torch.int8 if kv_quant else cfg.dtype

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    pool = {
        "kb": z((L, n_blocks, nh, block, hd), kv_dtype),
        "vb": z((L, n_blocks, nh, block, hd), kv_dtype),
        "block_tbl": z((n_slots, cache_len // block), torch.int32),
        "logits": z((n_slots, cfg.vocab_size), torch.float32),
        "slot_mask": z((n_slots, cache_len), torch.int32),
        "pos": z((n_slots,), torch.int32),
        "write": z((n_slots,), torch.int32),
    }
    if kv_quant:
        pool["kb_scale"] = z((L, n_blocks, nh, block, 1), torch.float32)
        pool["vb_scale"] = z((L, n_blocks, nh, block, 1), torch.float32)
    return pool


def _paged_gather(pool: dict) -> dict:
    """Dense VIEW of a paged pool (copies of every slot's rows); the non-KV
    planes are shared by reference."""
    tbl = pool["block_tbl"].long()
    L, _, nh, Bk, _ = pool["kb"].shape
    S, M = tbl.shape

    def g(plane):
        d = plane.shape[-1]
        return plane[:, tbl].permute(0, 1, 3, 2, 4, 5).reshape(L, S, nh, M * Bk, d)

    view = {k: v for k, v in pool.items() if k not in _PAGED_KEYS}
    view["k"], view["v"] = g(pool["kb"]), g(pool["vb"])
    if "kb_scale" in pool:
        view["k_scale"], view["v_scale"] = g(pool["kb_scale"]), g(pool["vb_scale"])
    return view


def _paged_scatter(pool: dict, view: dict) -> dict:
    """Write a dense view back into the block planes, skipping the sentinel
    (block 0 stays zero) and every block that more than one table row
    references. Those are copy-on-write prefix blocks: no pool op writes a
    shared column (suffix and decode writes land past the shared run;
    inactive decode lanes write back the bytes they read), so the view
    holds the bytes they already have. Every target left belongs to one
    row, so no two writes meet and the write order cannot matter."""
    tbl = pool["block_tbl"].long()
    Bk = paged_block(pool)
    refs = torch.bincount(tbl.flatten(), minlength=pool["kb"].shape[1])
    keep = (tbl > 0) & (refs[tbl] == 1)

    def s(plane, row):
        L, S, nh, C, d = row.shape
        x = row.reshape(L, S, nh, C // Bk, Bk, d).permute(0, 1, 3, 2, 4, 5)
        plane[:, tbl[keep]] = x[:, keep].to(plane.dtype)

    s(pool["kb"], view["k"])
    s(pool["vb"], view["v"])
    if "kb_scale" in pool:
        s(pool["kb_scale"], view["k_scale"])
        s(pool["vb_scale"], view["v_scale"])
    for key, val in view.items():
        if key not in ("k", "v", "k_scale", "v_scale"):
            pool[key] = val
    return pool


def paged_table_set(pool: dict, slot: int, row) -> dict:
    """Install ``slot``'s block-table row ((max_blocks,) int32, unallocated
    tail = sentinel 0)."""
    pool["block_tbl"][slot] = to_device(row, pool["block_tbl"].device, torch.int32)
    return pool


def paged_admit_cached(pool: dict, slot: int, row, n_cached: int) -> dict:
    """Copy-on-write counterpart of :func:`pool_admit_cached`: install
    ``slot``'s table row, whose first ``n_cached // block`` entries are
    pinned shared blocks holding the cached prompt prefix, and mark the
    first ``n_cached`` mask columns live (all others dead). No KV bytes
    move. The host then prefills the uncached suffix in right-padded pieces
    from column ``n_cached`` (``first=False``), which never write a shared
    block."""
    paged_table_set(pool, slot, row)
    C = pool["slot_mask"].shape[1]
    cols = torch.arange(C, device=pool["slot_mask"].device)
    pool["slot_mask"][slot] = (cols < int(n_cached)).to(torch.int32)
    return pool


# ---- prefix-cache block moves ----------------------------------------------
#
# Pure data movement between a slot's cache row, the dense pool's prefix
# arena and host blobs: the moved bytes are bit-identical to their source.
# Indexed reads and writes in place; no kernel.


def _kv_channels(pool: dict) -> list[tuple[str, str]]:
    """(cache key, arena key) pairs a block copy moves: the int8 scale
    planes ride along when the pool is quantized."""
    ch = [("k", "arena_k"), ("v", "arena_v")]
    if pool_quantized(pool):
        ch += [("k_scale", "arena_k_scale"), ("v_scale", "arena_v_scale")]
    return ch


def _arena_span(pool: dict, start: int, n: int) -> tuple[int, int]:
    """(clamped start, width) of an ``n``-block span of a dense cache row,
    clamped as ``dynamic_slice`` clamps it."""
    if pool_paged(pool):
        raise ValueError(
            "arena block copies are dense-pool machinery; a paged pool "
            "shares its own blocks (paged_admit_cached)"
        )
    w = n * pool["arena_k"].shape[3]
    return _clamp_start(start, w, pool["k"].shape[3]), w


def kv_extract(pool: dict, slot: int, start: int, idxs) -> dict:
    """Copy the KV span ``[start, start + n*block)`` of ``slot``'s cache row
    into arena blocks ``idxs`` ((n,) ids): publishes a prompt's freshly
    prefilled blocks into the prefix arena. The start clamps so the span
    fits the row, as ``dynamic_slice``. Dense pools only."""
    idxs = to_device(idxs, pool["slot_mask"].device, torch.long)
    st, w = _arena_span(pool, start, idxs.shape[0])
    for c, a in _kv_channels(pool):
        L, _, nh, _, d = pool[c].shape
        span = pool[c][:, slot, :, st:st + w]  # (L, nh, n*Bk, d)
        pool[a][idxs] = span.reshape(L, nh, len(idxs), -1, d).permute(2, 0, 1, 3, 4)
    return pool


def kv_insert(pool: dict, slot: int, start: int, idxs) -> dict:
    """Scatter arena blocks ``idxs`` into ``slot``'s cache row at ``[start,
    start + n*block)``, the inverse of :func:`kv_extract` (start clamped
    the same way). An arena block holds token i of its prefix at column
    i % block, so the copy is layout-exact only for a right-padded prompt
    (token i at column i, ``start = 0``). Dense pools only."""
    idxs = to_device(idxs, pool["slot_mask"].device, torch.long)
    st, w = _arena_span(pool, start, idxs.shape[0])
    for c, a in _kv_channels(pool):
        L, _, nh, _, d = pool[c].shape
        span = pool[a][idxs]  # (n, L, nh, Bk, d)
        pool[c][:, slot, :, st:st + w] = span.permute(1, 2, 0, 3, 4).reshape(L, nh, w, d)
    return pool


def pool_admit_cached(pool: dict, slot: int, idxs) -> dict:
    """Seed ``slot`` with a cached prompt prefix: arena blocks ``idxs`` land
    at cache columns ``[0, n*block)`` and the slot's mask row becomes 1
    there, 0 beyond, the state right-padded prefill pieces over those
    tokens would have left. The host then prefills the uncached suffix in
    pieces from column ``n*block`` (``first=False``), whose ``last`` piece
    stages the logits and cursors. Dense pools only (paged pools share
    blocks: :func:`paged_admit_cached`)."""
    kv_insert(pool, slot, 0, idxs)
    n_cached = len(idxs) * pool["arena_k"].shape[3]
    C = pool["slot_mask"].shape[1]
    cols = torch.arange(C, device=pool["slot_mask"].device)
    pool["slot_mask"][slot] = (cols < n_cached).to(torch.int32)
    return pool


def _block_store_channels(pool: dict) -> list[tuple[str, str]]:
    """(blob key, pool key) pairs of the pool's block store: the dense
    pool's prefix arena or the paged pool's block planes. Blob keys are the
    same for both, so a payload moves between pool kinds of one model."""
    if pool_paged(pool):
        ch = [("k", "kb"), ("v", "vb")]
        if pool_quantized(pool):
            ch += [("k_scale", "kb_scale"), ("v_scale", "vb_scale")]
        return ch
    return _kv_channels(pool)


def kv_block_export(pool: dict, idxs) -> dict:
    """Gather block-store blocks ``idxs`` into per-channel ``(n, L, nh,
    block, d)`` tensors on the pool's device (the tier-2 host blob layout):
    arena blocks of a dense pool, pool blocks of a paged one."""
    paged = pool_paged(pool)
    idxs = to_device(idxs, pool["slot_mask"].device, torch.long)
    out = {}
    for b, a in _block_store_channels(pool):
        if paged:  # (L, n_blocks, nh, Bk, d) -> (n, L, nh, Bk, d)
            out[b] = pool[a][:, idxs].transpose(0, 1).contiguous()
        else:
            out[b] = pool[a][idxs]
        if isinstance(out[b], ShardedTensor):  # whole heads for the host tier
            out[b] = all_gather(axis_shards(out[b]), dim=2)
    return out


def kv_block_import(pool: dict, idxs, blobs: dict) -> dict:
    """Scatter exported payloads (tensors on the pool's device) into
    block-store blocks ``idxs``, the inverse of :func:`kv_block_export`.
    The blob's channels must match the pool's (an int8 pool needs the
    scale planes)."""
    paged = pool_paged(pool)
    idxs = to_device(idxs, pool["slot_mask"].device, torch.long)
    for b, a in _block_store_channels(pool):
        if b not in blobs:
            raise ValueError(f"kv_block_import: blob missing channel {b!r}")
        blob = blobs[b].to(pool[a].dtype)
        if isinstance(pool[a], ShardedTensor):
            blob = split(blob, 2, pool[a].mesh)
        if paged:
            pool[a][:, idxs] = blob.transpose(0, 1)
        else:
            pool[a][idxs] = blob
    return pool
