"""Flash attention: hand-written CUDA kernels for Hopper and their plain
PyTorch versions. ``flash_attn`` is whole-sequence self-attention (the
encoder, and the decoder's whole-prompt prefill with ``causal=True``);
``flash_chunk_attn`` / ``flash_chunk_attn_paged`` are the chunked-prefill
reads of a piece against one slot's cache (further below).

Counterpart of ``pathway_tpu/models/flash_attention.py``: ``flash_attn``
has the same signature and layout — q/k/v (B, heads, S, head_dim) in the
compute dtype, a (B, S) mask of attendable columns, (B, heads, S,
head_dim) float32 out. The pad mask (and, with ``causal=True``, the
causal mask) is built inside the kernel from the (B, S) mask, so no
(B, heads, S, S) score, probability or bias tensor reaches device memory.
A query row with no attendable column comes out as exact zeros.

Routing is by the tensors' device and nothing else: CPU tensors take
``flash_attn_reference``; CUDA tensors launch ``csrc/flash_attn.cu`` or
raise. ``flash_attn.launches`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Large-negative finite sentinel rather than -inf: exp(-inf - -inf) is
# NaN where exp(_NEG - _NEG) is 1.0 (same value as the JAX kernel).
_NEG = -1e30


def flash_attn_reference(q, k, v, mask, *, causal=True, sm_scale=None):
    """Plain version: dense float32 masked softmax attention. A row with
    no live column divides by 1 and returns exact zeros, as the kernel
    does. Used for CPU tensors and as the kernel's yardstick."""
    hd = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    live = (mask > 0)[:, None, None, :]
    if causal:
        S = q.shape[2]
        tril = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        live = live & tril
    s = torch.where(live, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out / torch.where(l == 0.0, 1.0, l)


def _check_kernel_args(q, k, v, mask):
    if not (q.is_cuda and k.is_cuda and v.is_cuda and mask.is_cuda):
        raise ValueError("flash_attn: q, k, v and mask must all be CUDA tensors")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attn: q/k/v must be bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attn: q, k and v must share one dtype")
    if mask.dtype != torch.int32:
        raise TypeError(f"flash_attn: mask must be int32, got {mask.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attn: q/k/v must share one (B, heads, S, head_dim) shape, "
            f"got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    B, _, S, hd = q.shape
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"flash_attn: mask must be (B, S)=({B}, {S}), got {tuple(mask.shape)}")
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"flash_attn: head_dim must be a multiple of 8 in [8, 128], got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attn: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attn: {name} must be 16-byte aligned")


def flash_attn(q, k, v, mask, *, causal=True, sm_scale=None):
    """Flash attention over whole sequences.

    Args:
      q/k/v: (B, heads, S, head_dim), bf16 or f32, contiguous.
      mask: (B, S) attendable-column mask (>0 = live); int32 for the kernel.
      causal: also mask columns after each query's own position; False
        gives the encoder's pad-only masking.
      sm_scale: score scale; defaults to 1/sqrt(head_dim).

    Returns (B, heads, S, head_dim) float32 context.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attn_reference(q, k, v, mask, causal=causal,
                                    sm_scale=sm_scale)
    _check_kernel_args(q, k, v, mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # the kernel has no backward (nor has JAX's: no custom_vjp); its
        # output would cut the graph and leave the QKV weights without a
        # gradient, so training runs the dense core (encode(flash=False))
        raise RuntimeError("flash_attn: the kernel has no backward; differentiate "
                           "through the dense core (encode(..., flash=False))")
    from pathway_tpu_torch import kernels

    B, nh, S, hd = q.shape
    out = torch.empty((B, nh, S, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        kernels.launch(
            "flash_attn", "pathway_flash_attn",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B, nh, S, hd, float(sm_scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    flash_attn.launches += 1
    return out


flash_attn.launches = 0


# --------------------------------------------------------------------------
# Chunk-vs-cache attention for pool_prefill_chunk: a T-token query piece at
# offset ``start`` over one slot's cache row (dense) or block-table row
# (paged). One CUDA kernel (csrc/flash_chunk.cu) with two index modes.
# --------------------------------------------------------------------------

# The bf16 kernel cuts the live columns [0, min(C, start + T)) into splits
# of ``split_cols`` logical columns (a multiple of SPLIT_UNIT, the kernel's
# tile), one block per (64-query tile, head, split); split boundaries
# depend on neither the index mode nor the block size. CHUNK_SPLIT_COLS
# was chosen on the card (PERF.md): the main-path piece (12 heads, 64
# queries at column 448) launches 192 blocks on the 132 SMs. Past
# MAX_SPLITS splits the splits widen, which bounds the workspace.
SPLIT_UNIT, MAX_SPLITS, QUERY_TILE = 32, 64, 64
CHUNK_SPLIT_COLS = 32
# the split widths timed side by side on the card (chip_smoke.py)
SPLIT_CANDIDATES = (32, 64)


class ChunkPlan(NamedTuple):
    """Grid of the bf16 chunk kernel: ``q_tiles`` x heads x ``n_splits``
    blocks over the live columns ``[0, live_end)``; with ``n_splits`` > 1,
    ``part_floats`` f32 of partials (acc, then m and l) that a second
    kernel combines."""

    live_end: int
    split_cols: int
    n_splits: int
    q_tiles: int
    part_floats: int

    def splits(self):
        """[lo, hi) column range of each split, in order."""
        return [(s * self.split_cols, min((s + 1) * self.split_cols, self.live_end))
                for s in range(self.n_splits)]

    def blocks(self, nh: int) -> int:
        return self.q_tiles * nh * self.n_splits


def chunk_plan(nh, T, C, start, hd, split_cols=CHUNK_SPLIT_COLS) -> ChunkPlan:
    """Splits of ``split_cols`` columns over the live columns; wider (whole
    SPLIT_UNITs) where more than MAX_SPLITS would be needed."""
    live_end = max(0, min(C, start + T))
    n_units = -(-live_end // SPLIT_UNIT)
    if -(-live_end // split_cols) > MAX_SPLITS:
        split_cols = SPLIT_UNIT * -(-n_units // MAX_SPLITS)
    n_splits = max(1, -(-live_end // split_cols))
    return ChunkPlan(live_end, split_cols, n_splits, -(-T // QUERY_TILE),
                     nh * n_splits * T * (hd + 2) if n_splits > 1 else 0)


def flash_chunk_split_reference(q, k_row, v_row, row_mask, start, *,
                                k_scale=None, v_scale=None, sm_scale=None,
                                split_cols=CHUNK_SPLIT_COLS):
    """Plain version of the bf16 kernel's split-and-combine rule, in f32:
    per split of :func:`chunk_plan`, the running max m, the sum l of
    exp(s - m) and acc = sum exp(s - m) v; then, in split order over the
    splits with l > 0, out = sum e_s acc_s / sum e_s l_s with
    e_s = exp(m_s - max m). A row with no live column is exact zeros.
    Returns (heads, T, head_dim) float32."""
    nh, T, hd = q.shape
    C = k_row.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k, v = k_row.float(), v_row.float()
    if k_scale is not None:
        k = k * k_scale.float()
        v = v * v_scale.float()
    s = torch.einsum("ntd,ncd->ntc", q.float(), k) * sm_scale
    rows = int(start) + torch.arange(T, device=q.device)
    cols = torch.arange(C, device=q.device)
    live = ((row_mask > 0)[None, :] & (cols[None, :] <= rows[:, None]))[None]
    parts = []
    for lo, hi in chunk_plan(nh, T, C, int(start), hd, split_cols).splits():
        sl, lv = s[..., lo:hi], live[..., lo:hi]
        m = torch.where(lv, sl, _NEG).amax(dim=-1, keepdim=True)
        p = torch.where(lv, torch.exp(sl - m), 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True), p @ v[:, lo:hi]))
    mx = torch.full_like(parts[0][0], _NEG)
    for m, l, _ in parts:
        mx = torch.where(l > 0, torch.maximum(mx, m), mx)
    o = torch.zeros((nh, T, hd), dtype=torch.float32, device=q.device)
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        e = torch.where(l > 0, torch.exp(m - mx), 0.0)
        den = den + l * e
        o = o + e * acc
    return o / torch.where(den == 0.0, 1.0, den)


def flash_chunk_attn_reference(q, k_row, v_row, row_mask, start, *,
                               k_scale=None, v_scale=None, sm_scale=None):
    """Plain version over a dense row: query row t attends the columns
    ``live & (col <= start + t)``; int8 K/V are widened and scaled in f32.
    A row with nothing to attend is exact zeros. Returns (heads, T,
    head_dim) float32."""
    nh, T, hd = q.shape
    C = k_row.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k, v = k_row.float(), v_row.float()
    if k_scale is not None:
        k = k * k_scale.float()
        v = v * v_scale.float()
    s = torch.einsum("ntd,ncd->ntc", q.float(), k) * sm_scale
    rows = int(start) + torch.arange(T, device=q.device)
    cols = torch.arange(C, device=q.device)
    live = ((row_mask > 0)[None, :] & (cols[None, :] <= rows[:, None]))[None]
    s = torch.where(live, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("ntc,ncd->ntd", p, v) / torch.where(l == 0.0, 1.0, l)


def flash_chunk_attn_paged_reference(q, kb, vb, kb_scale, vb_scale, tbl_row,
                                     row_mask, start, *, sm_scale=None):
    """Plain version of the paged variant: gather the slot's row, then the
    dense plain version."""
    from pathway_tpu_torch.models.paged_attention import gather_rows

    def row(planes):
        return None if planes is None else gather_rows(planes, tbl_row[None])[0]

    return flash_chunk_attn_reference(
        q, row(kb), row(vb), row_mask, start, k_scale=row(kb_scale),
        v_scale=row(vb_scale), sm_scale=sm_scale,
    )


def _check_chunk_args(name, q, k, v, ks, vs, row_mask, C):
    ts = [("q", q), ("k", k), ("v", v), ("row_mask", row_mask)]
    if k.dtype == torch.int8:
        if ks is None or vs is None:
            raise ValueError(f"{name}: int8 K/V need k_scale and v_scale")
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32")
        if tuple(ks.shape) != tuple(k.shape[:-1]) + (1,) or vs.shape != ks.shape:
            raise ValueError(f"{name}: scales must be {tuple(k.shape[:-1]) + (1,)}")
        ts += [("k_scale", ks), ("v_scale", vs)]
    elif ks is not None or vs is not None:
        raise ValueError(f"{name}: scales are only taken with int8 K/V")
    for n, t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: {n} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if n in ("q", "k", "v") and t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be 16-byte aligned")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q must be bf16 or f32, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"{name}: K/V must share q's dtype, or be int8")
    if row_mask.dtype != torch.int32 or tuple(row_mask.shape) != (C,):
        raise ValueError(f"{name}: row_mask must be int32 ({C},)")
    hd = q.shape[-1]
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 in [8, 128], got {hd}")


def _launch_chunk(q, k, v, ks, vs, tbl_row, row_mask, start, C, Bk, sm_scale,
                  split_cols=CHUNK_SPLIT_COLS):
    from pathway_tpu_torch import kernels

    nh, T, hd = q.shape
    out = torch.empty((nh, T, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    quant = k.dtype == torch.int8
    # the f32-query kernel takes no plan
    plan = (chunk_plan(nh, T, C, int(start), hd, split_cols)
            if q.dtype == torch.bfloat16 else ChunkPlan(0, SPLIT_UNIT, 1, 1, 0))
    part = None
    if plan.n_splits > 1:
        part = torch.empty(plan.part_floats, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        kernels.launch(
            "flash_chunk", "pathway_flash_chunk_attn",
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
            None if tbl_row is None else tbl_row.data_ptr(),
            row_mask.data_ptr(), out.data_ptr(),
            nh, T, hd, C, Bk, int(start), float(sm_scale),
            int(q.dtype == torch.bfloat16), kernels.KV_KIND[k.dtype],
            plan.split_cols, plan.n_splits,
            None if part is None else part.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return out


def flash_chunk_attn(q, k_row, v_row, row_mask, start, *, k_scale=None,
                     v_scale=None, sm_scale=None):
    """Chunk-vs-cache attention over one slot's DENSE cache row.

    Args:
      q: (heads, T, head_dim) query piece, bf16 or f32.
      k_row/v_row: (heads, cache_len, head_dim) the slot's cache row (int8
        when quantized, else q's dtype).
      row_mask: (cache_len,) int32 live-column mask.
      start: absolute column of the piece's first query (int); query row t
        attends ``live & (col <= start + t)``.
      k_scale/v_scale: (heads, cache_len, 1) f32 scales, or None.

    Returns (heads, T, head_dim) float32. Tiles wholly past
    ``start + T - 1``, and columns that are not live, are not read.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_chunk_attn_reference(q, k_row, v_row, row_mask, start,
                                          k_scale=k_scale, v_scale=v_scale,
                                          sm_scale=sm_scale)
    nh, T, hd = q.shape
    C = k_row.shape[1]
    _check_chunk_args("flash_chunk_attn", q, k_row, v_row, k_scale, v_scale,
                      row_mask, C)
    if k_row.shape != (nh, C, hd) or v_row.shape != k_row.shape:
        raise ValueError(f"flash_chunk_attn: k_row/v_row must be ({nh}, C, {hd})")
    out = _launch_chunk(q, k_row, v_row, k_scale, v_scale, None, row_mask,
                        start, C, C, sm_scale)
    flash_chunk_attn.launches += 1
    return out


flash_chunk_attn.launches = 0


def flash_chunk_attn_paged(q, kb, vb, kb_scale, vb_scale, tbl_row, row_mask,
                           start, *, sm_scale=None):
    """Chunk-vs-cache attention straight over the paged pool's physical
    block planes ``kb``/``vb`` (n_blocks, heads, block, head_dim), walking
    ONE slot's block-table row ``tbl_row`` (M,) int32; ``row_mask`` is
    (M * block,) in logical order. Same contract as
    :func:`flash_chunk_attn` on the gathered row."""
    nh, T, hd = q.shape
    Bk = kb.shape[2]
    M = tbl_row.shape[0]
    if row_mask.shape[0] != M * Bk:
        raise ValueError(
            f"row_mask width {row_mask.shape[0]} != table blocks {M} x block {Bk}"
        )
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return flash_chunk_attn_paged_reference(
            q, kb, vb, kb_scale, vb_scale, tbl_row, row_mask, start,
            sm_scale=sm_scale)
    _check_chunk_args("flash_chunk_attn_paged", q, kb, vb, kb_scale, vb_scale,
                      row_mask, M * Bk)
    if kb.dim() != 4 or kb.shape[1] != nh or kb.shape[3] != hd or vb.shape != kb.shape:
        raise ValueError(f"flash_chunk_attn_paged: kb/vb must be (n_blocks, {nh}, block, {hd})")
    if (not tbl_row.is_cuda or tbl_row.dtype != torch.int32
            or not tbl_row.is_contiguous()):
        raise ValueError("flash_chunk_attn_paged: tbl_row must be a contiguous int32 CUDA tensor")
    out = _launch_chunk(q, kb, vb, kb_scale, vb_scale, tbl_row, row_mask,
                        start, M * Bk, Bk, sm_scale)
    flash_chunk_attn_paged.launches += 1
    return out


flash_chunk_attn_paged.launches = 0


# --------------------------------------------------------------------------
# Attention-bytes accounting model (copied from the JAX package)
# --------------------------------------------------------------------------

def attn_bytes_dense(n_q, n_k, heads, batch=1):
    """Bytes the DENSE path materializes per attention call, per layer:
    f32 scores + probs (B, nh, Sq, Sk) and the additive mask bias
    (B, 1, Sq, Sk) — the quadratic objects flash eliminates. An
    accounting model, not a hardware counter."""
    return 4 * batch * n_q * n_k * (2 * heads + 1)


def attn_bytes_flash(n_q, n_k, heads, head_dim, batch=1, itemsize=4):
    """Bytes the flash kernel streams per attention call, per layer:
    q and o once, k and v once each, plus the (max, denom) running
    stats — linear in sequence length. ``itemsize`` is the KV element
    size (1 for int8 cached KV, whose scales add one f32 per token)."""
    qo = 4 * batch * heads * 2 * n_q * head_dim
    kv = itemsize * batch * heads * 2 * n_k * head_dim
    if itemsize == 1:
        kv += 4 * batch * heads * 2 * n_k
    stats = 4 * batch * heads * 2 * n_q
    return qo + kv + stats
