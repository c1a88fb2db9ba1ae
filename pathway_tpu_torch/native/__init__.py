"""The port's C++ host loops, built at first use: the batch tokenizers
(``_tokenize.cpp``) and the dataflow engine's loops (``_engine.cpp``:
column hashing, delta consolidation, the row transpose, the
connectors' record extraction and the hash join's loops).

``g++ -O3 -shared -fPIC`` compiles each source into a CPython extension in
``build/pathway_tpu_torch/`` beside the package (listed in
``.gitignore``), named by a hash of the source and flags, so a changed
source is rebuilt and an unchanged one reused. The library is written
under a temporary name and moved into place with ``os.replace``: several
processes may build it at once, and none sees half a file. A missing
``g++`` or a failed build raises; nothing falls back. The Python tokenize
path runs only when a tokenizer is built with ``native=False``; the
engine's loops hand back the rows they cannot encode (see each wrapper).
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
_ENGINE_SRC = Path(__file__).resolve().parent / "_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "pathway_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


def lib_path(src: "Path | None" = None) -> Path:
    src = src or _SRC
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(src.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}{suffix}"


def build(src: "Path | None" = None) -> Path:
    """Compile ``src`` (the tokenizers by default) unless it is built
    already; returns its path."""
    src = src or _SRC
    path = lib_path(src)
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: the port's native {src.name} "
                           "cannot be built (tokenizers: pass native=False for "
                           "the Python path)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [gxx, *FLAGS, f"-I{sysconfig.get_paths()['include']}", str(src),
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native {src.name} build failed (g++ exited "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, path)  # atomic: readers never see half a file
    finally:
        tmp.unlink(missing_ok=True)
    return path


def lib(src: "Path | None" = None):
    """The loaded extension module of ``src`` (the tokenizers by default),
    built on first use."""
    src = src or _SRC
    mod = _libs.get(src)
    if mod is None:
        with _lock:
            mod = _libs.get(src)
            if mod is None:
                spec = importlib.util.spec_from_file_location(src.stem, build(src))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _libs[src] = mod
    return mod


def engine_lib():
    """The engine's loops (``_engine.cpp``), built on first use; the
    engine's ``Pointer`` type is registered with it once, so pointers hash
    as JAX's engine hashes them."""
    mod = _libs.get(_ENGINE_SRC)
    if mod is None:
        from pathway_tpu_torch.engine.value import Pointer

        mod = lib(_ENGINE_SRC)
        mod.set_pointer_type(Pointer)
    return mod


def hash_object_column(col) -> "tuple[np.ndarray, list]":
    """Per-row XXH64 of the canonical encoding of an object column:
    (uint64 digests, indices of rows the C++ encoder does not handle:
    arrays, Json, datetimes, ints beyond 64 bits; the caller hashes those
    in Python)."""
    out = np.empty(len(col), dtype=np.uint64)
    fallback = engine_lib().hash_object_column(col, memoryview(out.view(np.uint8)))
    return out, fallback


def consolidate_pairs(keys, rowh, diffs):
    """Group rows by (key, row hash), sum their diffs, drop zero groups:
    (first index of each kept group, its summed diff), by first index."""
    idx_b, diff_b = engine_lib().consolidate_pairs(
        memoryview(np.ascontiguousarray(keys, dtype=np.uint64)),
        memoryview(np.ascontiguousarray(rowh, dtype=np.uint64)),
        memoryview(np.ascontiguousarray(diffs, dtype=np.int64)),
    )
    return np.frombuffer(idx_b, dtype=np.uint64), np.frombuffer(diff_b, dtype=np.int64)


def batch_rows_split(rows, ncols: int, keys, diffs):
    """The SoA transpose of ``(key, row, diff)`` triples: fills the uint64
    ``keys`` and int64 ``diffs`` arrays, returns one value list a column.
    Raises ``TypeError`` for entries that are not such triples."""
    return engine_lib().batch_rows_split(rows, ncols, memoryview(keys), memoryview(diffs))


def rows_from_records(records, cols, codes, defaults):
    """Record dicts -> row tuples with the fast coercions: (rows, indices
    of records that need the Python parser)."""
    return engine_lib().rows_from_records(records, cols, codes, defaults)


def jsonl_rows(data: bytes, cols, codes, defaults, columnar: int = 0):
    """JSON-lines bytes -> row tuples (or column lists with ``columnar=1``)
    with the fast coercions; lines it cannot parse come back as
    ``(index, bytes)`` for the Python parser."""
    return engine_lib().jsonl_rows(data, cols, codes, defaults, columnar)


def join_apply_side(state, key2jk, keys, diffs, col_lists, jk_idx, error):
    """One side's batch applied to a join's buckets (``state``: join key
    -> {row key: row}; ``key2jk``: row key -> its join key), the join key
    the column at ``jk_idx``: (deltas per join key, dirty join keys, undo
    log per join key, rows whose join key was ``error``)."""
    return engine_lib().join_apply_side(state, key2jk, keys, diffs, col_lists, jk_idx,
                                        error)


def join_ld_cross(works, sides: bytes, idxs: list):
    """The delta x bucket cross products of one join step, columnar: (one
    value list per output column, pair keys as uint64 bytes, diffs as
    int64 bytes). ``works`` holds ``(delta, bucket[, swapped])`` items;
    ``sides``/``idxs`` say which side and position each output column
    reads."""
    return engine_lib().join_ld_cross(works, sides, idxs)


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of a bytes-like object (the C++ form of ``engine.xxh64``)."""
    return engine_lib().xxh64_digest(data, seed)


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
