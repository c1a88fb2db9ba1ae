"""Corpus-sharded brute-force KNN with a top-k merge (counterpart of
``pathway_tpu/parallel/sharded_knn.py``).

The corpus is row-sharded over the mesh's ``dp`` axis and a query batch is
used whole on every shard. One search does, per shard,

    local gemm -> local top-k -> all_gather(k per shard) -> merged top-k

so only ``dp * k`` candidates per query leave a shard. The scoring and the
stable top-k are ``ops/knn.py``'s. The host keeps the key <-> global-slot
map; adds take the least-loaded shard, growth doubles every shard and
remaps slots, and pending writes flush as one pow2-padded batch.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.ops import next_pow2
from pathway_tpu_torch.ops.knn import _topk_stable, knn_scores
from pathway_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    P,
    ShardedTensor,
    all_gather,
    axis_shards,
)

_NEG_INF = -1e30


def _merge_topk(sc_parts: list, idx_parts: list, k: int):
    """Merge per-shard (Q, k_local) candidates: shard-major flatten, then
    one stable top-k (ties to the lower shard, as ``lax.top_k``)."""
    flat_sc = all_gather(sc_parts, dim=1)   # (Q, dp * k_local)
    flat_idx = all_gather(idx_parts, dim=1)
    m_sc, m_pos = _topk_stable(flat_sc, min(k, flat_sc.shape[1]))
    return m_sc, torch.gather(flat_idx, 1, m_pos)


def _row_sharded(t: torch.Tensor, mesh: Mesh) -> ShardedTensor:
    return ShardedTensor.place(t, mesh, P(DATA_AXIS, *([None] * (t.dim() - 1))))


def sharded_topk_merge(mesh: Mesh, corpus, valid, queries, k: int,
                       metric: str = "cos"):
    """Functional entry: ``corpus`` (rows, d) and ``valid`` (rows,) sharded
    on dp rows (plain tensors are sharded first), ``queries`` (Q, d) used
    whole. Returns ``(scores (Q, k'), global rows (Q, k'))`` on shard 0's
    device."""
    if not isinstance(corpus, ShardedTensor):
        corpus = _row_sharded(corpus, mesh)
    if not isinstance(valid, ShardedTensor):
        valid = _row_sharded(valid, mesh)
    c_parts, v_parts = axis_shards(corpus, DATA_AXIS), axis_shards(valid, DATA_AXIS)
    shard_rows = c_parts[0].shape[0]
    k_local = min(k, shard_rows)
    sc_parts, idx_parts = [], []
    for s, (c, v) in enumerate(zip(c_parts, v_parts)):
        sc, idx = _topk_stable(knn_scores(c, v, queries.to(c.device), metric), k_local)
        sc_parts.append(sc)
        idx_parts.append(idx + s * shard_rows)
    return _merge_topk(sc_parts, idx_parts, k)


class ShardedKnnIndex:
    """Multi-device KNN index: the dense state is row-sharded on the mesh,
    the host keeps the irregular key <-> slot bookkeeping."""

    def __init__(self, mesh: Mesh, dimensions: int, reserved_space: int = 1024,
                 metric: str = "cos", dtype=torch.bfloat16):
        self.mesh = mesh
        self.dp = mesh.shape[DATA_AXIS]
        self.dim = dimensions
        self.metric = "l2" if str(metric).lower().startswith("l2") else "cos"
        self.dtype = dtype
        per = max(64, int(math.ceil(reserved_space / self.dp)))
        self._alloc(next_pow2(per, 64))
        self._slot_of: dict[Any, int] = {}
        self._key_of: dict[int, Any] = {}
        self._free = self._fresh_free_lists()
        self._host_dirty: list[tuple[int, np.ndarray | None]] = []

    def _fresh_free_lists(self) -> list[list[int]]:
        """Per-shard free-slot stacks (adds take the least-loaded shard)."""
        return [list(range(s * self.shard_rows, (s + 1) * self.shard_rows))
                for s in range(self.dp)]

    def _alloc(self, shard_rows: int, corpus=None, valid=None) -> None:
        total = shard_rows * self.dp
        dev = self.mesh.devices[0]
        if corpus is None:
            corpus = torch.zeros((total, self.dim), dtype=self.dtype, device=dev)
            valid = torch.zeros((total,), dtype=torch.bool, device=dev)
        self._corpus = _row_sharded(corpus, self.mesh)
        self._valid = _row_sharded(valid, self.mesh)
        self.shard_rows = shard_rows

    def __len__(self) -> int:
        return len(self._slot_of)

    def _grow(self) -> None:
        """Double every shard; global slot ``shard * old + r`` moves to
        ``shard * new + r``."""
        old_c, old_v = self._corpus.gather(), self._valid.gather()
        old_rows, new_rows = self.shard_rows, self.shard_rows * 2
        newc = old_c.new_zeros((new_rows * self.dp, self.dim))
        newv = old_v.new_zeros((new_rows * self.dp,))
        for s in range(self.dp):
            newc[s * new_rows:s * new_rows + old_rows] = old_c[s * old_rows:(s + 1) * old_rows]
            newv[s * new_rows:s * new_rows + old_rows] = old_v[s * old_rows:(s + 1) * old_rows]
        self._alloc(new_rows, newc, newv)
        remap = {}
        for key, g in self._slot_of.items():
            shard, r = divmod(g, old_rows)
            remap[key] = shard * new_rows + r
        self._slot_of = remap
        self._key_of = {v: k for k, v in remap.items()}
        used = set(remap.values())
        self._free = [[g for g in free if g not in used]
                      for free in self._fresh_free_lists()]

    def add(self, key, vector: np.ndarray) -> None:
        if key in self._slot_of:
            self.remove(key)
        if not any(self._free):
            self._flush()
            self._grow()
        shard = max(range(self.dp), key=lambda s: len(self._free[s]))
        slot = self._free[shard].pop()
        self._slot_of[key] = slot
        self._key_of[slot] = key
        self._host_dirty.append((slot, np.asarray(vector, dtype=np.float32)))

    def remove(self, key) -> None:
        slot = self._slot_of.pop(key, None)
        if slot is None:
            return
        self._key_of.pop(slot, None)
        self._free[slot // self.shard_rows].append(slot)
        self._host_dirty.append((slot, None))

    def _flush(self) -> None:
        """Apply pending adds and removes as one batch, padded to a pow2
        bucket with copies of row 0 as in JAX. A slot written twice keeps
        its last write (JAX's scatter leaves duplicate order open)."""
        if not self._host_dirty:
            return
        last = {slot: vec for slot, vec in self._host_dirty}
        n_dirty = len(last)
        bucket = next_pow2(n_dirty, 64)
        slots = np.zeros((bucket,), dtype=np.int64)
        vecs = np.zeros((bucket, self.dim), dtype=np.float32)
        vmask = np.zeros((bucket,), dtype=bool)
        for i, (slot, vec) in enumerate(last.items()):
            slots[i] = slot
            if vec is not None:
                if self.metric == "cos":
                    n = np.linalg.norm(vec)
                    if n > 0:
                        vec = vec / n
                vecs[i] = vec
                vmask[i] = True
        slots[n_dirty:], vecs[n_dirty:], vmask[n_dirty:] = slots[0], vecs[0], vmask[0]
        self._host_dirty.clear()
        for p, j in enumerate(self._corpus.index):
            if p != self._corpus.index.index(j):
                continue  # a shared shard: written once
            r0 = self.mesh.coords(p)[DATA_AXIS] * self.shard_rows
            sel = (slots >= r0) & (slots < r0 + self.shard_rows)
            if not sel.any():
                continue
            c, v = self._corpus.shards[j], self._valid.shards[self._valid.index[p]]
            rows = torch.as_tensor(slots[sel] - r0, device=c.device)
            c[rows] = torch.as_tensor(vecs[sel], device=c.device).to(c.dtype)
            v[rows] = torch.as_tensor(vmask[sel], device=v.device)

    def search(self, queries: np.ndarray, k: int):
        """queries (Q, d) -> [(key, score), ...] per query."""
        self._flush()
        if not self._slot_of:
            return [[] for _ in range(len(queries))]
        q = np.asarray(queries, dtype=np.float32)
        if self.metric == "cos":
            q = q / np.clip(np.linalg.norm(q, axis=1, keepdims=True), 1e-9, None)
        Q = q.shape[0]
        qpad = np.zeros((next_pow2(Q), self.dim), dtype=np.float32)
        qpad[:Q] = q
        sc, idx = sharded_topk_merge(self.mesh, self._corpus, self._valid,
                                     torch.as_tensor(qpad, device=self.mesh.devices[0]),
                                     k, self.metric)
        sc, idx = sc[:Q].cpu().numpy(), idx[:Q].cpu().numpy()
        out = []
        for r in range(Q):
            row = []
            for c in range(sc.shape[1]):
                if sc[r, c] <= _NEG_INF / 2:
                    continue
                key = self._key_of.get(int(idx[r, c]))
                if key is not None:
                    row.append((key, float(sc[r, c])))
            out.append(row[:k])
        return out
