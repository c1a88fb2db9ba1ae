"""The port's C++ batch tokenizers (``_tokenize.cpp``), built at first use.

``g++ -O3 -shared -fPIC`` compiles the source into a CPython extension in
``build/pathway_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of the source and flags, so a changed
source is rebuilt and an unchanged one reused. The library is written
under a temporary name and moved into place with ``os.replace``: several
processes may build it at once, and none sees half a file. A missing
``g++`` or a failed build raises; nothing falls back. The Python tokenize
path runs only when a tokenizer is built with ``native=False``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "_tokenize.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "pathway_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(_SRC.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_tokenize-{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the extension unless it is built already; returns its path."""
    path = lib_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native tokenizers "
                           "cannot be built (pass native=False for the Python path)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [gxx, *FLAGS, f"-I{sysconfig.get_paths()['include']}", str(_SRC),
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native tokenizer build failed (g++ exited "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, path)  # atomic: readers never see half a file
    finally:
        tmp.unlink(missing_ok=True)
    return path


def lib():
    """The loaded extension module, built on first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                spec = importlib.util.spec_from_file_location("_tokenize", build())
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _lib = mod
    return _lib


def hash_tokenize(texts: list, max_length: int, reserved: int, span: int):
    """Batch HashTokenizer ids: (writable (n, width) int32 matrix, fallback
    row indices to re-tokenize in Python: texts with non-ASCII bytes)."""
    buf, width, fallback = lib().hash_tokenize(texts, max_length, reserved, span)
    return np.frombuffer(buf, dtype=np.int32).reshape(len(texts), width), fallback


def wordpiece_load(tokens) -> int:
    """Register a WordPiece vocab (token strings, index = id); returns the
    handle that :func:`wordpiece_tokenize` and :func:`wordpiece_free` take.
    A freed handle's slot is reused."""
    return lib().wordpiece_load(list(tokens))


def wordpiece_free(handle: int) -> None:
    lib().wordpiece_free(handle)


def wordpiece_tokenize(handle: int, texts: list, max_length: int, cls_id: int,
                       sep_id: int, unk_id: int, pad_id: int):
    """Batch WordPiece ids: (writable (n, width) int32 matrix, per-row real
    lengths, fallback row indices: texts with non-ASCII bytes)."""
    buf, width, lens_buf, fallback = lib().wordpiece_tokenize(
        handle, texts, max_length, cls_id, sep_id, unk_id, pad_id)
    ids = np.frombuffer(buf, dtype=np.int32).reshape(len(texts), width)
    return ids, np.frombuffer(lens_buf, dtype=np.uint32), fallback
