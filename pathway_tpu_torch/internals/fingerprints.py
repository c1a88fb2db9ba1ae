"""Stable object fingerprints (counterpart of ``pathway_tpu/internals/fingerprints.py``,
reference ``internals/fingerprints.py:fingerprint``), copied exactly: the LSH
bucket ids are fingerprints, so they equal the JAX package's bit for bit.

Used by the LSH bucketers to collapse per-band integer bucket vectors into a
single bucket id, and generally anywhere a deterministic, content-addressed
hash of a Python object is needed.
"""

from __future__ import annotations

import hashlib

_FORMATS = {
    "hash",
    "hex",
    "token",
    "short_token",
    "bytes",
    "bignum",
    "u64",
    "i64",
    "bigint",
    "u32",
    "integer",
    "i32",
    "u16",
    "i16",
}


def fingerprint(obj, *, format: str = "hex", seed=""):  # noqa: A002
    """Deterministic fingerprint of ``obj`` in the requested ``format``.

    ``format`` is one of: hash, hex, token, short_token, bytes, bignum,
    u64, i64, bigint, u32, integer, i32, u16, i16.  ``seed`` salts the hash.
    """
    h = hashlib.blake2b(f"{seed}{obj}".encode(), digest_size=16)
    if format == "hash":
        return h
    if format == "hex":
        return h.hexdigest()
    if format == "token":
        return h.hexdigest()[-16:]
    if format == "short_token":
        return h.hexdigest()[-8:]
    if format == "bytes":
        return h.digest()
    big = int(h.hexdigest(), 16)
    if format == "bignum":
        return big
    if format == "u64":
        return big % (2**64)
    if format == "i64":
        return big % (2**64) - (2**63)
    if format == "bigint":
        return big % (2**63)
    if format == "u32":
        return big % (2**32)
    if format == "integer":
        # non-negative 31-bit (reference format table distinguishes this
        # from signed 'i32')
        return big % (2**31)
    if format == "i32":
        return big % (2**32) - (2**31)
    if format == "u16":
        return big % (2**16)
    if format == "i16":
        return big % (2**16) - (2**15)
    raise ValueError(
        f"unknown fingerprint format {format!r}; expected one of {sorted(_FORMATS)}"
    )
