"""Fused int8-weight matmul: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of ``pathway_tpu/models/wq_matmul.py``: ``wq_matmul(x, w,
scale)`` computes ``x (M, K) @ dequant(w (K, N) int8)`` with the scale
``(1, N)`` float32 applied per output channel, float32 out. The kernel
(``csrc/wq_matmul.cu``) stages each int8 weight tile in shared memory,
widens it there (int8 values are exact in bf16 and f32), accumulates in
f32 and scales the output columns, so no full-precision copy of the
weight is ever written. M and N are guarded inside the kernel: any M and
N work, and nothing outside the operands is read.

Routing is by the tensors' device and nothing else: CPU tensors take
``wq_matmul_reference``; CUDA tensors launch the kernel or raise.
``wq_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch


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
    with torch.cuda.device(x.device):
        kernels.launch(
            "wq_matmul", "pathway_wq_matmul",
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, K, N, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    wq_matmul.launches += 1
    return out


wq_matmul.launches = 0
