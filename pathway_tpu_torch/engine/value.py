"""Engine values, keys and sharding.

Parity target: reference ``src/engine/value.rs`` (``Key`` = 128-bit xxh3 of
value bytes, ``Value`` 18-variant enum, ``ShardPolicy``), redesigned:

* ``Key`` is a **64-bit** XXH64 hash (numpy ``uint64``) so whole key columns are
  dense vectors — usable directly in vectorized gather/scatter/sort code and
  cheap to exchange between workers. The reference uses u128 for collision
  headroom at its scale; at 64 bits collision probability for 10^9 keys is
  ~2.7e-2 per *pair*table-level birthday bound ~ 2.7%% at 10^9.5 — acceptable
  here and recoverable by widening later (keys are opaque to users).
* Values are plain Python objects in object-dtype columns, EXCEPT dense numeric
  columns (int64/float64/bool) which live as typed numpy arrays.
* ``ERROR`` and ``Pending`` are singleton sentinels matching the reference's
  ``Value::Error`` and async-UDF pending semantics.

The port's keys are the JAX package's keys bit for bit: the same canonical
encoding and the same XXH64, computed by the port's own C++ loop
(``native/_engine.cpp``) with its Python path beside it
(``engine/xxh64.py``), so neither ``xxhash`` nor ``pandas`` is imported
here. Datetimes encode as pandas' nanosecond value, read from pandas only
when pandas is already loaded (no pandas object exists otherwise).
"""

from __future__ import annotations

import datetime
import struct
import sys
from typing import Any

import numpy as np

from pathway_tpu_torch.engine.xxh64 import xxh64_intdigest

# ---------------------------------------------------------------------------
# sentinels


class _ErrorValue:
    """Singleton error sentinel (reference ``Value::Error``)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self):
        raise ValueError("Error value is not a bool")

    def __reduce__(self):
        return (_ErrorValue, ())


class _PendingValue:
    """Singleton pending sentinel for not-yet-resolved async UDF results."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Pending"

    def __reduce__(self):
        return (_PendingValue, ())


ERROR = _ErrorValue()
Pending = _PendingValue()


class Pointer:
    """A row reference — wraps a 64-bit key. Reference: ``Value::Pointer``."""

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = int(value) & 0xFFFFFFFFFFFFFFFF

    def __repr__(self) -> str:
        return f"^{_base32(self.value)}"

    def __eq__(self, other) -> bool:
        return isinstance(other, Pointer) and self.value == other.value

    def __lt__(self, other) -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value < other.value

    def __le__(self, other) -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value <= other.value

    def __gt__(self, other) -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value > other.value

    def __ge__(self, other) -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value >= other.value

    def __hash__(self) -> int:
        return self.value

    def __class_getitem__(cls, item):
        import typing

        return typing.Annotated[cls, item]

    def __reduce__(self):
        return (Pointer, (self.value,))


_B32_ALPHA = "0123456789ABCDEFGHIJKLMNOPQRSTUV"


def _base32(v: int) -> str:
    out = []
    for _ in range(13):
        out.append(_B32_ALPHA[v & 31])
        v >>= 5
    return "".join(reversed(out))


# ---------------------------------------------------------------------------
# stable serialization for hashing (canonical tagged encoding)

_TAG_NONE = b"\x00"
_TAG_BOOL = b"\x01"
_TAG_INT = b"\x02"
_TAG_FLOAT = b"\x03"
_TAG_STR = b"\x04"
_TAG_BYTES = b"\x05"
_TAG_PTR = b"\x06"
_TAG_TUPLE = b"\x07"
_TAG_ARRAY = b"\x08"
_TAG_JSON = b"\x09"
_TAG_DTN = b"\x0a"
_TAG_DTU = b"\x0b"
_TAG_DUR = b"\x0c"
_TAG_ERROR = b"\x0d"
_TAG_OBJ = b"\x0e"
_TAG_BIGINT = b"\x0f"


def serialize_value(value: Any, out: bytearray) -> None:
    """Canonical byte encoding — equal values encode identically."""
    from pathway_tpu_torch.internals.json import Json

    if value is None:
        out += _TAG_NONE
    elif isinstance(value, (bool, np.bool_)):
        out += _TAG_BOOL
        out += b"\x01" if value else b"\x00"
    elif isinstance(value, (int, np.integer)):
        v = int(value)
        if -(2**63) <= v < 2**63:
            out += _TAG_INT
            out += struct.pack("<q", v)
        else:
            # distinct tag so big ints can't collide with i64 encodings
            b = v.to_bytes((v.bit_length() + 8) // 8, "little", signed=True)
            out += _TAG_BIGINT
            out += struct.pack("<I", len(b))
            out += b
    elif isinstance(value, (float, np.floating)):
        out += _TAG_FLOAT
        out += struct.pack("<d", float(value))
    elif isinstance(value, str):
        b = value.encode("utf-8")
        out += _TAG_STR
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(value, bytes):
        out += _TAG_BYTES
        out += struct.pack("<I", len(value))
        out += value
    elif isinstance(value, Pointer):
        out += _TAG_PTR
        out += struct.pack("<Q", value.value)
    elif isinstance(value, (tuple, list)):
        out += _TAG_TUPLE
        out += struct.pack("<I", len(value))
        for v in value:
            serialize_value(v, out)
    elif isinstance(value, np.ndarray):
        out += _TAG_ARRAY
        arr = np.ascontiguousarray(value)
        shape = arr.shape
        out += struct.pack("<B", arr.ndim)
        for s in shape:
            out += struct.pack("<Q", s)
        kind = arr.dtype.kind.encode()
        out += kind
        if arr.dtype == object:
            for v in arr.ravel():
                serialize_value(v, out)
        else:
            out += arr.tobytes()
    elif isinstance(value, Json):
        out += _TAG_JSON
        b = str(value).encode("utf-8")
        out += struct.pack("<I", len(b))
        out += b
    elif _is_pd_timedelta(value):
        out += _TAG_DUR
        out += struct.pack("<q", value.value)
    elif isinstance(value, datetime.datetime):
        out += _TAG_DTU if value.tzinfo is not None else _TAG_DTN
        out += struct.pack("<q", _datetime_ns(value))
    elif value is ERROR:
        out += _TAG_ERROR
    else:
        # arbitrary python object — fall back to pickle (PyObjectWrapper parity)
        import pickle

        try:
            b = pickle.dumps(value, protocol=4)
        except Exception:  # noqa: BLE001 - unpicklable (e.g. local class):
            # hash by identity token. Only consolidation equality is
            # affected; routing uses row keys, never object-column hashes.
            b = struct.pack("<Q", _identity_token(value))
        out += _TAG_OBJ
        out += struct.pack("<I", len(b))
        out += b


def _is_pd_timedelta(value) -> bool:
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(value, pd.Timedelta)


_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _datetime_ns(value: datetime.datetime) -> int:
    """``pd.Timestamp(value).value``: nanoseconds since the epoch (UTC for
    an aware value), computed without pandas for a plain datetime."""
    pd = sys.modules.get("pandas")
    if pd is not None:
        return pd.Timestamp(value).value
    epoch = _EPOCH_UTC if value.tzinfo is not None else _EPOCH
    return ((value - epoch) // datetime.timedelta(microseconds=1)) * 1000


# Identity tokens for unpicklable objects: raw id() would falsely equate two
# distinct objects when CPython reuses a freed address; a weakref-guarded
# monotonic token stays unique for the life of each object.
_identity_tokens: dict[int, tuple] = {}
_identity_counter = [0]


def _identity_token(obj) -> int:
    import weakref

    addr = id(obj)
    entry = _identity_tokens.get(addr)
    if entry is not None and entry[0]() is obj:
        return entry[1]
    _identity_counter[0] += 1
    tok = _identity_counter[0] & 0xFFFFFFFFFFFFFFFF
    try:
        ref = weakref.ref(obj)
    except TypeError:
        ref = (lambda o: (lambda: o))(obj)  # unweakrefable: pin it
    _identity_tokens[addr] = (ref, tok)
    return tok


SHARD_BITS = 16
SHARD_MASK = (1 << SHARD_BITS) - 1  # reference: value.rs SHARD_MASK low 16 bits


def hash_one(value: Any) -> int:
    """64-bit hash of a single value."""
    buf = bytearray()
    serialize_value(value, buf)
    return _digest()(bytes(buf))


def _digest():
    """The C++ XXH64 (built at first use; a failed build raises)."""
    global _digest_fn
    if _digest_fn is None:
        from pathway_tpu_torch import native

        _digest_fn = native.engine_lib().xxh64_digest
    return _digest_fn


_digest_fn = None


def _mix_scalar(h: int, idx: int) -> int:
    x = (h + (_SEQ_SALT * (idx + 1))) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def hash_values(*values: Any) -> int:
    """64-bit key from values — reference ``Key::for_values`` analog.

    Defined as an order-dependent combine of per-value hashes so that the
    vectorized column path (``keys_for_value_columns``) produces identical
    keys — ``pointer_from(a, b)`` must agree with ``with_id_from(a, b)``.
    """
    acc = None
    for idx, v in enumerate(values):
        h = _mix_scalar(hash_one(v), idx)
        acc = h if acc is None else ((acc * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF) ^ h
    if acc is None:
        return 0
    return acc


def ref_scalar(*values: Any) -> Pointer:
    return Pointer(hash_values(*values))


def ref_scalar_with_instance(*values: Any, instance: Any) -> Pointer:
    """Instance-colocated pointer: low shard bits come from the instance hash
    so all rows of one instance land on one worker (reference
    ``ShardPolicy::LastKeyColumn``, value.rs:94-115)."""
    main = hash_values(*values, instance)
    inst = hash_values(instance)
    return Pointer((main & ~SHARD_MASK) | (inst & SHARD_MASK))


def keys_with_instance(keys: np.ndarray, instance_col: np.ndarray) -> np.ndarray:
    """Vectorized ``ref_scalar_with_instance`` low-bit replacement: the
    instance hash must be ``hash_values(instance)`` (idx-mixed), NOT the raw
    per-value hash, so results agree bit-for-bit with the scalar path."""
    inst = keys_for_value_columns(
        [np.asarray(instance_col, dtype=object)], len(keys)
    )
    return (keys & np.uint64(~SHARD_MASK & 0xFFFFFFFFFFFFFFFF)) | (
        inst & np.uint64(SHARD_MASK)
    )


def shard_of_key(key: int, n_shards: int) -> int:
    return (key & SHARD_MASK) % n_shards


def shard_of_keys(keys: np.ndarray, n_shards: int) -> np.ndarray:
    return (keys & np.uint64(SHARD_MASK)) % np.uint64(n_shards)


# Vectorized key derivation ---------------------------------------------------

_SEQ_SALT = 0x9E3779B97F4A7C15


def hash_keys_with(keys: np.ndarray, salt: int) -> np.ndarray:
    """Vectorized splitmix64-style rehash of a key column (for derived
    universes: filter/flatten/reindex produce fresh-but-deterministic keys)."""
    with np.errstate(over="ignore"):
        x = keys.astype(np.uint64) + np.uint64(salt & 0xFFFFFFFFFFFFFFFF)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def hash_value_column(col: np.ndarray, native: bool = True) -> np.ndarray:
    """Per-row 64-bit hashes of a value column (``hash_one`` per row).
    The C++ column hasher encodes and digests the rows it handles and
    hands back the rest, which take the Python encoder; ``native=False``
    runs the whole column through the Python encoder and the Python
    XXH64 (the same keys, slower)."""
    if col.dtype != object:
        col = col.astype(object)
    if native:
        from pathway_tpu_torch import native as native_mod

        out, fallback = native_mod.hash_object_column(col)
        for i in fallback:
            out[i] = hash_one(col[i])
        return out
    out = np.empty(len(col), dtype=np.uint64)
    for i, v in enumerate(col):
        buf = bytearray()
        serialize_value(v, buf)
        out[i] = xxh64_intdigest(bytes(buf))
    return out


def keys_for_value_columns(cols: list[np.ndarray], n: int) -> np.ndarray:
    """Vectorized ``Key::for_values`` over columns — consistent with
    ``hash_values`` applied row-wise."""
    if not cols:
        return np.zeros(n, dtype=np.uint64)
    acc = None
    with np.errstate(over="ignore"):
        for idx, col in enumerate(cols):
            h = hash_value_column(np.asarray(col, dtype=object))
            h = hash_keys_with(h, _SEQ_SALT * (idx + 1))
            acc = h if acc is None else (acc * np.uint64(0x100000001B3)) ^ h
    return acc
