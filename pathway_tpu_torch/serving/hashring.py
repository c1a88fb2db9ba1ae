"""Consistent-hash ring with virtual nodes, keyed on prompt-head blocks
(counterpart of ``pathway_tpu/serving/hashring.py``).

Each replica's prefix KV cache is its own, so a shared prompt head pays
its prefill once only if every request carrying it lands on the same
replica. The ring key is the prompt's first ``blocks`` full token blocks
(:func:`head_block_key`): prompts that differ past that head key alike,
and the virtual nodes keep the keys a membership change moves near K/N.
The block size is the serving side's prefix-cache block
(:func:`affinity_block_tokens`), so a ring-key match implies a prefix
match on the owning replica.

Positions are blake2b digests, as in JAX: the same members and keys give
the same owners in both packages and in every process. The ring records
no metrics; callers count ``ring_moves`` from what :meth:`HashRing.add`
and :meth:`HashRing.remove` return.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Sequence

from pathway_tpu_torch.analysis.annotations import guarded_by
from pathway_tpu_torch.analysis.runtime import make_lock
from pathway_tpu_torch.ops import next_pow2


def _point(data: bytes) -> int:
    """64-bit ring position of ``data`` (stable, unlike the salted
    ``hash()``)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def affinity_block_tokens(prefill_chunk: int = 64, prefix_block: int = 0) -> int:
    """The token block the router hashes on: the server's prefix-cache
    block for these arguments (``DecoderChat``'s ``prefill_chunk`` and
    ``prefix_block``; the defaults are the JAX flag defaults, 64 and 0)."""
    chunk = max(8, next_pow2(int(prefill_chunk), 8))
    return next_pow2(max(int(prefix_block), chunk), chunk)


def head_block_key(tokens: Sequence[int], *, block: int, blocks: int) -> bytes:
    """Ring key of a prompt: its first ``blocks`` full ``block``-token
    groups. A prompt shorter than one block keys on all its tokens."""
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if blocks <= 0:
        raise ValueError(f"blocks must be positive, got {blocks}")
    n_full = min(len(tokens) // block, blocks)
    head = tuple(int(t) for t in tokens[: n_full * block])
    if not head:
        head = tuple(int(t) for t in tokens)
    return repr(head).encode("utf-8")


@guarded_by(_points="_lock", _ids="_lock", _members="_lock")
class HashRing:
    """Consistent-hash ring of ``vnodes`` virtual nodes per member. All
    state is guarded by ``_lock``; a lookup is a binary search over the
    sorted positions."""

    def __init__(self, *, vnodes: int = 64) -> None:
        if vnodes <= 0:
            raise ValueError(f"vnodes must be positive, got {vnodes}")
        self.vnodes = int(vnodes)
        self._lock = make_lock("serving.hashring")
        self._points: list[int] = []  # sorted vnode positions
        self._ids: list[str] = []  # owner of each position
        self._members: dict[str, list[int]] = {}  # id -> its positions

    def add(self, replica_id: str) -> int:
        """Insert ``replica_id``'s vnodes; returns the arcs that changed
        owner (0 when it is already a member)."""
        with self._lock:
            if replica_id in self._members:
                return 0
            pts = [_point(f"{replica_id}#{v}".encode("utf-8")) for v in range(self.vnodes)]
            for p in pts:
                i = bisect.bisect_left(self._points, p)
                self._points.insert(i, p)
                self._ids.insert(i, replica_id)
            self._members[replica_id] = pts
            return len(pts)

    def remove(self, replica_id: str) -> int:
        """Take ``replica_id`` off the ring; returns the arcs moved (0 when
        it was not a member)."""
        with self._lock:
            pts = self._members.pop(replica_id, None)
            if pts is None:
                return 0
            for p in pts:
                i = bisect.bisect_left(self._points, p)
                while i < len(self._points) and self._points[i] == p:
                    if self._ids[i] == replica_id:
                        del self._points[i]
                        del self._ids[i]
                        break
                    i += 1
            return len(pts)

    def lookup(self, key: bytes) -> str | None:
        """Owner of ``key``: the first vnode clockwise from its position
        (wrapping); None on an empty ring."""
        with self._lock:
            if not self._points:
                return None
            i = bisect.bisect_right(self._points, _point(key))
            return self._ids[0 if i == len(self._points) else i]

    def members(self) -> list[str]:
        with self._lock:
            return sorted(self._members)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def __contains__(self, replica_id: str) -> bool:
        with self._lock:
            return replica_id in self._members
