"""XXH64 in Python: the engine's row-key digest without the ``xxhash``
package.

From the public algorithm specification (github.com/Cyan4973/xxHash,
public domain). ``xxh64_intdigest`` equals ``xxhash.xxh64_intdigest`` and
the C++ form in ``native/_engine.cpp`` (``native.xxh64``); the engine's
hot paths hash through the C++ form, this one is the column loop's Python
path and the reference the tests hold both against.
"""

from __future__ import annotations

_M = 0xFFFFFFFFFFFFFFFF
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & _M
    return (_rotl(acc, 31) * P1) & _M


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * P1 + P4) & _M


def xxh64_intdigest(data: bytes, seed: int = 0) -> int:
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & _M
        v2 = (seed + P2) & _M
        v3 = seed & _M
        v4 = (seed - P1) & _M
        frombytes = int.from_bytes
        while p <= n - 32:
            v1 = _round(v1, frombytes(data[p:p + 8], "little"))
            v2 = _round(v2, frombytes(data[p + 8:p + 16], "little"))
            v3 = _round(v3, frombytes(data[p + 16:p + 24], "little"))
            v4 = _round(v4, frombytes(data[p + 24:p + 32], "little"))
            p += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + P5) & _M
    h = (h + n) & _M
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * P1 + P4) & _M
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * P1) & _M
        h = (_rotl(h, 23) * P2 + P3) & _M
        p += 4
    while p < n:
        h ^= (data[p] * P5) & _M
        h = (_rotl(h, 11) * P1) & _M
        p += 1
    h ^= h >> 33
    h = (h * P2) & _M
    h ^= h >> 29
    h = (h * P3) & _M
    h ^= h >> 32
    return h
