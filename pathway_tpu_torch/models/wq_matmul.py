"""Fused int8-weight matmul: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of ``pathway_tpu/models/wq_matmul.py``: ``wq_matmul(x, w,
scale)`` computes ``x (M, K) @ dequant(w (K, N) int8)`` with the scale
``(1, N)`` float32 applied per output channel, float32 out. The kernel
(``csrc/wq_matmul.cu``) streams int8 weight tiles through shared memory,
widens them in registers (int8 values are exact in bf16 and f32),
accumulates in f32 (bf16 x on the tensor cores) and scales the output
columns, so no full-precision copy of the weight is ever written. M, K and
N are guarded inside the kernel: any shape works, and nothing outside the
operands is read. For bf16 x, :func:`wq_plan` cuts K into splits so that
a decode product fills the card; the splits of a column tile run as one
thread-block cluster and add their sums in split order, so results do not
vary from run to run.

Routing is by the tensors' device and nothing else: CPU tensors take
``wq_matmul_reference``; CUDA tensors launch the kernel or raise.
``wq_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathway_tpu_torch.kernels import SMS

# the bf16 kernel's tile: output columns and rows a block owns, and the
# k rows of one mma step (a split is a whole number of them); the splits of
# a column tile form one thread-block cluster, of at most 8 blocks
TILE_N, TILE_M, STEP_K, MAX_SPLITS = 32, 64, 16, 8
# two blocks a streaming multiprocessor: faster on the card than one
# (PERF.md), as more, smaller K splits keep more weight bytes in flight
MIN_BLOCKS = 2 * SMS


class WqPlan(NamedTuple):
    """Grid of the bf16 kernel for one (M, K, N): ``n_tiles`` column tiles
    x ``n_splits`` K splits of ``k_per_split`` rows x ``row_groups`` groups
    of 64-row tiles."""

    n_tiles: int
    n_splits: int
    k_per_split: int
    row_groups: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.n_splits * self.row_groups


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wq_plan(M: int, K: int, N: int) -> WqPlan:
    """Split K (and spread row tiles) until the grid has at least
    MIN_BLOCKS blocks where the shape allows it. Row tiles go first, since
    they need no reduction; K splits are whole 16-row steps, none of them
    empty, and at most MAX_SPLITS."""
    n_tiles, steps, row_tiles = _cdiv(N, TILE_N), _cdiv(K, STEP_K), _cdiv(M, TILE_M)
    need = _cdiv(MIN_BLOCKS, n_tiles)
    groups = min(row_tiles, need)
    groups = _cdiv(row_tiles, _cdiv(row_tiles, groups))
    per_split = max(steps // _cdiv(need, groups), _cdiv(steps, MAX_SPLITS))
    return WqPlan(n_tiles, _cdiv(steps, per_split), STEP_K * per_split, groups)


def wq_matmul_reference(x, w, scale):
    """Plain version: widen, multiply in f32, scale per output column."""
    return torch.matmul(x.float(), w.float()) * scale.float().reshape(1, -1)


def _check_kernel_args(x, w, scale):
    if not (x.is_cuda and w.is_cuda and scale.is_cuda):
        raise ValueError("wq_matmul: x, w and scale must all be CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"wq_matmul: x must be bf16 or f32, got {x.dtype}")
    if w.dtype != torch.int8:
        raise TypeError(f"wq_matmul: w must be int8, got {w.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"wq_matmul: scale must be float32, got {scale.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"wq_matmul: x (M, K) and w (K, N) do not fit: "
            f"{tuple(x.shape)} {tuple(w.shape)}"
        )
    if scale.numel() != w.shape[1]:
        raise ValueError(f"wq_matmul: scale must hold N={w.shape[1]} values")
    for name, t in (("x", x), ("w", w), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"wq_matmul: {name} must be contiguous")


def wq_matmul(x, w, scale):
    """Fused-dequant matmul.

    Args:
      x: (M, K) activations, bf16 or f32.
      w: (K, N) int8 weight.
      scale: (1, N) or (N,) float32 per-output-channel scale.

    Returns (M, N) float32.
    """
    if x.device.type == "cpu":
        return wq_matmul_reference(x, w, scale)
    _check_kernel_args(x, w, scale)
    from pathway_tpu_torch import kernels

    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    # the f32 kernel takes no plan
    plan = wq_plan(M, K, N) if bf16 else WqPlan(1, 1, STEP_K * _cdiv(K, STEP_K), 1)
    with torch.cuda.device(x.device):
        kernels.launch(
            "wq_matmul", "pathway_wq_matmul",
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, K, N, int(bf16), plan.k_per_split, plan.n_splits,
            plan.row_groups, torch.cuda.current_stream(x.device).cuda_stream,
        )
    wq_matmul.launches += 1
    return out


wq_matmul.launches = 0
