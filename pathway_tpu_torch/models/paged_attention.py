"""Paged-attention decode: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of ``pathway_tpu/models/paged_attention.py``. One decode
position per serving slot, over the global paged KV pool
(``decoder.paged_pool_init``): slot ``b``'s logical cache column ``c``
lives in physical block ``tbl[b, c // block]`` at block column
``c % block``. Block 0 is the sentinel (zeros, always masked). With int8
K/V the per-token f32 scales are multiplied in where a tile is read, so no
dequantized copy of the cache exists. A slot with no live column divides
by 1 and returns exact zeros.

Routing is by the tensors' device and nothing else: CPU tensors take
``paged_attn_decode_reference``; CUDA tensors launch ``csrc/paged_attn.cu``
or raise. ``paged_attn_decode.launches`` counts kernel launches.

For bf16 queries the kernel splits each slot's table row across blocks
(flash-decoding); :func:`decode_plan` sizes the splits on the host and
:func:`paged_attn_decode_split_reference` is the plain version of the
split-and-combine arithmetic.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_NEG = -1e30  # finite sentinel, as in the JAX kernel

# The bf16 kernel cuts each slot's table row into splits of
# ``split_cols // block`` entries (at least one), one block per (split,
# head, slot); a (slot, head)'s splits are one thread-block cluster, so at
# most MAX_SPLITS (a portable cluster), past which the splits widen.
# DECODE_SPLIT_COLS was chosen on the card among SPLIT_CANDIDATES
# (chip_smoke.py times them side by side; PERF.md).
MAX_SPLITS = 8
DECODE_SPLIT_COLS = 256
SPLIT_CANDIDATES = (128, 256, 512)


class DecodePlan(NamedTuple):
    """Grid of the bf16 kernel: ``n_splits`` splits of ``entries`` table
    entries per (slot, head)."""

    entries: int
    n_splits: int

    def splits(self, M: int):
        """[lo, hi) table entries of each split, in order."""
        return [(s * self.entries, min((s + 1) * self.entries, M))
                for s in range(self.n_splits)]

    def blocks(self, B: int, nh: int) -> int:
        return B * nh * self.n_splits


def decode_plan(M, Bk, split_cols=DECODE_SPLIT_COLS) -> DecodePlan:
    """Splits of ``split_cols // Bk`` table entries (at least one), widened
    where more than MAX_SPLITS would be needed. At the main-path shape (16
    slots x 12 heads, 11 entries of 64 columns) the default makes 3 splits:
    576 blocks for the 132 SMs."""
    entries = max(1, split_cols // Bk)
    if -(-M // entries) > MAX_SPLITS:
        entries = -(-M // MAX_SPLITS)
    return DecodePlan(entries, -(-M // entries))


def gather_rows(kb, tbl):
    """(n_blocks, heads, block, d) planes and a (B, M) table -> the dense
    (B, heads, M * block, d) rows in logical column order."""
    B, M = tbl.shape
    _, nh, Bk, d = kb.shape
    x = kb[tbl.long()]  # (B, M, nh, Bk, d)
    return x.permute(0, 2, 1, 3, 4).reshape(B, nh, M * Bk, d)


def paged_attn_decode_reference(q, kb, vb, kb_scale, vb_scale, tbl, slot_mask,
                                *, sm_scale=None):
    """Plain version: gather each slot's rows, dequantize in f32, dense f32
    masked softmax; output in ``q.dtype``."""
    hd = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k = gather_rows(kb, tbl).float()
    v = gather_rows(vb, tbl).float()
    if kb_scale is not None:
        k = k * gather_rows(kb_scale, tbl).float()
        v = v * gather_rows(vb_scale, tbl).float()
    s = torch.einsum("bnd,bntd->bnt", q.float(), k) * sm_scale
    live = (slot_mask > 0)[:, None, :]
    s = torch.where(live, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnt,bntd->bnd", p, v) / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)


def paged_attn_decode_split_reference(q, kb, vb, kb_scale, vb_scale, tbl,
                                      slot_mask, *, sm_scale=None,
                                      split_cols=DECODE_SPLIT_COLS):
    """Plain version of the bf16 kernel's split-and-combine rule, in f32:
    per split of :func:`decode_plan`, the running max m, the sum l of
    exp(s - m) and acc = sum exp(s - m) v over its live columns; then, in
    split order over the splits with l > 0, out = sum e_s acc_s /
    sum e_s l_s with e_s = exp(m_s - max m). A slot with no live column is
    exact zeros. Output in ``q.dtype``."""
    B, nh, hd = q.shape
    Bk = kb.shape[2]
    M = tbl.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k = gather_rows(kb, tbl).float()
    v = gather_rows(vb, tbl).float()
    if kb_scale is not None:
        k = k * gather_rows(kb_scale, tbl).float()
        v = v * gather_rows(vb_scale, tbl).float()
    s = torch.einsum("bnd,bntd->bnt", q.float(), k) * sm_scale
    live = (slot_mask > 0)[:, None, :]
    parts = []
    for lo, hi in decode_plan(M, Bk, split_cols).splits(M):
        sl, lv = s[..., lo * Bk:hi * Bk], live[..., lo * Bk:hi * Bk]
        m = torch.where(lv, sl, _NEG).amax(dim=-1, keepdim=True)
        p = torch.where(lv, torch.exp(sl - m), 0.0)
        acc = torch.einsum("bnt,bntd->bnd", p, v[:, :, lo * Bk:hi * Bk])
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    mx = torch.full_like(parts[0][0], _NEG)
    for m, l, _ in parts:
        mx = torch.where(l > 0, torch.maximum(mx, m), mx)
    out = torch.zeros((B, nh, hd), dtype=torch.float32, device=q.device)
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        e = torch.where(l > 0, torch.exp(m - mx), 0.0)
        den = den + l * e
        out = out + e * acc
    return (out / torch.where(den == 0.0, 1.0, den)).to(q.dtype)


def _check_kernel_args(q, kb, vb, kb_scale, vb_scale, tbl, slot_mask):
    ts = [("q", q), ("kb", kb), ("vb", vb), ("tbl", tbl), ("slot_mask", slot_mask)]
    if kb.dtype == torch.int8:
        if kb_scale is None or vb_scale is None:
            raise ValueError("paged_attn_decode: int8 K/V need kb_scale and vb_scale")
        ts += [("kb_scale", kb_scale), ("vb_scale", vb_scale)]
        for name, t in ts[-2:]:
            if t.dtype != torch.float32 or tuple(t.shape) != tuple(kb.shape[:3]) + (1,):
                raise ValueError(f"paged_attn_decode: {name} must be f32 {tuple(kb.shape[:3]) + (1,)}")
    elif kb_scale is not None or vb_scale is not None:
        raise ValueError("paged_attn_decode: scales are only taken with int8 K/V")
    for name, t in ts:
        if not t.is_cuda:
            raise ValueError(f"paged_attn_decode: {name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"paged_attn_decode: {name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_attn_decode: q must be bf16 or f32, got {q.dtype}")
    if kb.dtype != vb.dtype or kb.dtype not in (q.dtype, torch.int8):
        raise TypeError("paged_attn_decode: kb/vb must share q's dtype, or be int8")
    if tbl.dtype != torch.int32 or slot_mask.dtype != torch.int32:
        raise TypeError("paged_attn_decode: tbl and slot_mask must be int32")
    B, nh, hd = q.shape
    if kb.dim() != 4 or vb.shape != kb.shape or kb.shape[1] != nh or kb.shape[3] != hd:
        raise ValueError(f"paged_attn_decode: kb/vb must be (n_blocks, {nh}, block, {hd})")
    if tbl.dim() != 2 or tbl.shape[0] != B:
        raise ValueError(f"paged_attn_decode: tbl must be ({B}, blocks per slot)")
    if not 1 <= hd <= 256:
        raise ValueError(f"paged_attn_decode: head_dim must be in [1, 256], got {hd}")


def paged_attn_decode(q, kb, vb, kb_scale, vb_scale, tbl, slot_mask, *,
                      sm_scale=None):
    """Single-position paged attention for every slot in one launch.

    Args:
      q: (n_slots, heads, head_dim) query at each slot's write position.
      kb/vb: (n_blocks, heads, block, head_dim) one layer's physical block
        planes (int8 when quantized, else q's dtype).
      kb_scale/vb_scale: (n_blocks, heads, block, 1) f32 scales, or None.
      tbl: (n_slots, cache_len // block) int32 block table; 0 = sentinel.
      slot_mask: (n_slots, cache_len) int32 live-column mask, logical order.

    Returns (n_slots, heads, head_dim) in ``q.dtype``.
    """
    B, nh, hd = q.shape
    Bk = kb.shape[2]
    M = tbl.shape[1]
    if slot_mask.shape[1] != M * Bk:
        raise ValueError(
            f"slot_mask width {slot_mask.shape[1]} != table blocks {M} x block {Bk}"
        )
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return paged_attn_decode_reference(q, kb, vb, kb_scale, vb_scale, tbl,
                                           slot_mask, sm_scale=sm_scale)
    _check_kernel_args(q, kb, vb, kb_scale, vb_scale, tbl, slot_mask)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(q, kb, vb, kb_scale, vb_scale, tbl, slot_mask, out, sm_scale)
    paged_attn_decode.launches += 1
    return out


paged_attn_decode.launches = 0


def _launch(q, kb, vb, kb_scale, vb_scale, tbl, slot_mask, out, sm_scale,
            split_cols=DECODE_SPLIT_COLS):
    from pathway_tpu_torch import kernels

    B, nh, hd = q.shape
    Bk = kb.shape[2]
    M = tbl.shape[1]
    quant = kb.dtype == torch.int8
    # the f32-query kernel takes no plan
    plan = decode_plan(M, Bk, split_cols) if q.dtype == torch.bfloat16 else DecodePlan(M, 1)
    with torch.cuda.device(q.device):
        kernels.launch(
            "paged_attn", "pathway_paged_attn_decode",
            q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
            kb_scale.data_ptr() if quant else None,
            vb_scale.data_ptr() if quant else None,
            tbl.data_ptr(), slot_mask.data_ptr(), out.data_ptr(),
            B, nh, hd, Bk, M, float(sm_scale),
            int(q.dtype == torch.bfloat16), kernels.KV_KIND[kb.dtype],
            plan.entries, plan.n_splits,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out
