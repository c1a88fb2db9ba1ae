"""Build and bind the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch header is involved, so a build takes seconds. Libraries go to
``build/pathway_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is reused. All sources build in
parallel, one ``nvcc`` process each, at first use. A missing ``nvcc`` or a
failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pathway_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# the K/V element type code of the attention kernels' C interface
KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# library name -> (source file, {exported function: ctypes argtypes})
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "flash_attn": (
        "flash_attn.cu",
        {
            # q, k, v, mask, out, B, nh, S, hd, sm_scale, causal, is_bf16,
            # stream
            "pathway_flash_attn": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                   _I, _I, _P),
        },
    ),
    "flash_chunk": (
        "flash_chunk.cu",
        {
            # q, k, v, k_scale, v_scale, tbl_row, row_mask, out, nh, T, hd,
            # C, block, start, sm_scale, q_bf16, kv_kind, split_cols,
            # n_splits, part, stream
            "pathway_flash_chunk_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                         _I, _P, _P),
        },
    ),
    "paged_attn": (
        "paged_attn.cu",
        {
            # q, kb, vb, kb_scale, vb_scale, tbl, slot_mask, out, B, nh, hd,
            # block, blocks per slot, sm_scale, q_bf16, kv_kind, entries,
            # n_splits, stream
            "pathway_paged_attn_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _I, _I, _F, _I, _I, _I, _I,
                                          _P),
        },
    ),
    "wq_matmul": (
        "wq_matmul.cu",
        {
            # x, w, scale, out, M, K, N, x_bf16, k_per_split, n_splits,
            # row_groups, stream
            "pathway_wq_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _P),
        },
    ),
}

# streaming multiprocessors of the H100 SXM: the host-side plans size
# their grids to at least this many blocks
SMS = 132

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from pathway_tpu_torch.internals.config import env_interpolate

    home = env_interpolate("CUDA_HOME") or env_interpolate("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or /usr/local/cuda): "
        "the port's CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    # a header change rebuilds every library that may include it
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every listed kernel library (all by default) that is not
    built yet, all ``nvcc`` processes at once. Returns name -> path."""
    names = list(KERNELS) if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, todo[n])  # atomic: readers never see half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in KERNELS[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int  # cudaError_t
            _loaded[name] = lib
    return lib


def launch(name: str, fn: str, *args) -> None:
    """Call ``fn`` of kernel library ``name``; raise on a non-zero
    ``cudaError_t`` (a refused launch never runs, and a later synchronise
    would not report it)."""
    err = getattr(library(name), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: cudaError_t {err}")
