"""Ring attention: exact attention with the sequence axis sharded over a
mesh axis (counterpart of ``pathway_tpu/parallel/ring_attention.py``).

Each sequence shard keeps a flash-style running (max, denominator,
weighted sum) for its resident queries while the K/V shards (and their
padding masks) rotate one hop around the ring per step, shard ``j``'s
going to shard ``j + 1``. The last hop, which would only bring K/V home,
is skipped. On the single controller a hop is ``.to(device)``: a peer copy
between cards, nothing on a repeated device. Torch ops, as JAX's
``shard_map`` body is plain ``jnp`` (no Pallas).
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.models import transformer as T
from pathway_tpu_torch.parallel.mesh import Mesh

_MASK_BIAS = -1e9


def _accumulate(acc, q, k, v, msk, scale: float):
    o, m, l = acc
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + torch.where(msk[:, None, None, :] > 0, 0.0, _MASK_BIAS)
    new_m = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - new_m)  # exp(-inf - x) == 0
    p = torch.exp(scores - new_m)
    o = o * alpha + torch.matmul(p.to(v.dtype).float(), v.float())
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    return o, new_m, l


def ring_attention_core(q, k, v, kv_mask, scale: float | None = None) -> list:
    """Exact attention of every query shard against the whole (rotated)
    K/V. ``q``, ``k``, ``v``: per-shard lists of (B, nh, S_loc, hd) in
    ring order, each on its shard's device; ``kv_mask``: per-shard (B,
    S_loc) padding masks, rotating with K/V. Returns the per-shard (B, nh,
    S_loc, hd) float32 contexts.

    Fully masked blocks are harmless: their contributions are wiped by the
    ``exp(m - new_m)`` rescale once any real block raises the running max
    (every encoder input has at least one live token)."""
    n = len(q)
    if scale is None:
        scale = 1.0 / math.sqrt(q[0].shape[-1])
    accs, ks, vs, ms = [], list(k), list(v), list(kv_mask)
    for i in range(n):
        B, nh, S, hd = q[i].shape
        dev = q[i].device
        acc = (torch.zeros((B, nh, S, hd), dtype=torch.float32, device=dev),
               torch.full((B, nh, S, 1), -math.inf, dtype=torch.float32, device=dev),
               torch.zeros((B, nh, S, 1), dtype=torch.float32, device=dev))
        accs.append(_accumulate(acc, q[i], ks[i], vs[i], ms[i], scale))
    for _ in range(n - 1):
        # one hop: shard j's K/V/mask move to shard j + 1
        ks, vs, ms = ([t[(j - 1) % n].to(q[j].device) for j in range(n)]
                      for t in (ks, vs, ms))
        accs = [_accumulate(accs[j], q[j], ks[j], vs[j], ms[j], scale) for j in range(n)]
    return [o / torch.clamp(l, min=1e-30) for o, _, l in accs]


def encode_sequence_parallel(params: dict, input_ids, attention_mask,
                             cfg: T.TransformerConfig, mesh: Mesh,
                             sp_axis: str = "sp") -> torch.Tensor:
    """Encoder forward with the sequence sharded over ``mesh.shape[sp_axis]``
    positions and ring attention between them. Everything but attention is
    per token and runs on the local shard. Returns (B, S, H) float32, the
    values of ``transformer.encode`` up to accumulation order; S must be a
    multiple of the axis size. ``params`` must be whole on the host side
    of each shard (plain tensors; they move to each shard's device)."""
    n = mesh.shape[sp_axis]
    B, S = input_ids.shape
    if S % n != 0:
        raise ValueError(f"sequence length {S} not divisible by sp={n}")
    S_loc = S // n
    scale = 1.0 / math.sqrt(cfg.head_dim)
    devs = [mesh.devices[p] for p in range(mesh.size)
            if all(v == 0 for a, v in mesh.coords(p).items() if a != sp_axis)]
    emb = params["embeddings"]
    xs, masks = [], []
    for i, dev in enumerate(devs):
        ids = input_ids[:, i * S_loc:(i + 1) * S_loc].to(dev).long()
        masks.append(attention_mask[:, i * S_loc:(i + 1) * S_loc].to(dev))
        rows = emb["word"].to(dev)[ids]
        ws = emb.get("word_scale")
        if ws is not None:
            rows = rows.float() * ws.to(dev)[ids]
        pos = emb["position"].to(dev)[i * S_loc:(i + 1) * S_loc]
        x = rows + pos[None] + emb["type"].to(dev)[0]
        xs.append(T._layer_norm(x, emb["ln_scale"].to(dev), emb["ln_bias"].to(dev),
                                cfg.layer_norm_eps).to(cfg.dtype))
    layers = params["layers"]
    for li in range(cfg.layers):
        lps = [{name: p[li].to(dev) for name, p in layers.items()} for dev in devs]
        qkv = [tuple(T._qkv_heads(x, lp, cfg)) for x, lp in zip(xs, lps)]
        ctxs = ring_attention_core([t[0] for t in qkv], [t[1] for t in qkv],
                                   [t[2] for t in qkv], masks, scale)
        xs = [T._layer_rest(x, T._attn_out(c, lp, cfg), lp, cfg)
              for x, c, lp in zip(xs, ctxs, lps)]
    return torch.cat([x.float().to(devs[0]) for x in xs], dim=1)
