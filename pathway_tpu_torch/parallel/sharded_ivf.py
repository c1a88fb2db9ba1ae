"""Corpus-sharded IVF-Flat: one inverted file per shard and a top-k merge
(counterpart of ``pathway_tpu/parallel/sharded_ivf.py``).

Every ``dp`` shard owns its own centroids and cell-major block. One search
does, per shard,

    centroid gemm -> top-nprobe cells -> member gemm + top-k
    -> all_gather(k per shard) -> merged top-k

through ``ops/ivf.py``'s ``_ivf_search``, so per query only ``dp * k``
candidates leave a shard while each shard scans ``nprobe / n_cells`` of
its block. The host keeps numpy mirrors of the cells (IVF training moves
rows between cells anyway) and re-places them on the mesh after a change.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.engine.probes import record_retrieval_backend
from pathway_tpu_torch.ops import canonical_metric, next_pow2, prep_host_vectors
from pathway_tpu_torch.ops.ivf import _ivf_search, kmeans_fit
from pathway_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, ShardedTensor, axis_shards
from pathway_tpu_torch.parallel.sharded_knn import _merge_topk, _row_sharded

_NEG_INF = -1e30


def sharded_ivf_topk_merge(mesh: Mesh, cells, valid, centroids, queries,
                           k: int, nprobe: int, metric: str = "cos"):
    """``cells`` (dp*C, cap, d), ``valid`` (dp*C, cap), ``centroids``
    (dp*C, d), each sharded on axis 0 (plain tensors are sharded first);
    ``queries`` (Q, d) used whole. Returns ``(scores (Q, k'), global
    slots (Q, k'))``, a global slot being ``shard * (C * cap) + cell *
    cap + slot``."""
    cells, valid, centroids = (
        t if isinstance(t, ShardedTensor) else _row_sharded(t, mesh)
        for t in (cells, valid, centroids))
    sc_parts, idx_parts = [], []
    for s, (c, v, cent) in enumerate(zip(axis_shards(cells, DATA_AXIS),
                                         axis_shards(valid, DATA_AXIS),
                                         axis_shards(centroids, DATA_AXIS))):
        C, cap = c.shape[0], c.shape[1]
        k_local = min(k, nprobe * cap)
        sc, cell_ids, slots = _ivf_search(c, v, cent, queries.to(c.device),
                                          k_local, nprobe, metric)
        sc_parts.append(sc)
        idx_parts.append(cell_ids.long() * cap + slots + s * (C * cap))
    return _merge_topk(sc_parts, idx_parts, k)


class ShardedIvfIndex:
    """Multi-chip IVF index: host routes each key to the least-loaded shard
    and into that shard's nearest cell; the dense state lives
    device-sharded. Centroids are seeded per shard from its first batch and
    refined with k-means once ``train_after`` vectors have arrived
    (matching the single-chip ``IvfFlatIndex`` lifecycle)."""

    def __init__(self, mesh: Mesh, dimensions: int, n_cells: int = 64,
                 nprobe: int = 8, cell_capacity: int = 64,
                 metric: str = "cos", train_after: int | None = None,
                 dtype=torch.bfloat16):
        self.mesh = mesh
        self.dp = mesh.shape[DATA_AXIS]
        self.dim = dimensions
        self.n_cells = n_cells
        self.nprobe = min(nprobe, n_cells)
        self.cell_cap = next_pow2(cell_capacity, 16)
        self.metric = canonical_metric(metric)
        self.dtype = dtype
        self.train_after = (
            n_cells * 16 if train_after is None else train_after
        )
        self._trained = False
        self._pending: list[np.ndarray] = []
        # host mirrors (synced to device on flush) — simpler than the
        # brute-force index's dirty-scatter because IVF rebuilds move rows
        # between cells at train time anyway
        total = self.dp * n_cells
        self._h_cells = np.zeros((total, self.cell_cap, dimensions),
                                 np.float32)
        self._h_valid = np.zeros((total, self.cell_cap), bool)
        self._h_centroids: np.ndarray | None = None  # (dp*C, d)
        self._key_of: dict[int, Any] = {}     # global slot -> key
        self._loc: dict[Any, int] = {}        # key -> global slot
        self._shard_count = [0] * self.dp
        self._dev = None  # (cells, valid, centroids) device copies

    def __len__(self) -> int:
        return len(self._loc)

    def _prep(self, vectors) -> np.ndarray:
        return prep_host_vectors(vectors, self.metric)

    def _seed(self, v: np.ndarray) -> None:
        if self._h_centroids is not None:
            return
        total = self.dp * self.n_cells
        reps = int(np.ceil(total / max(len(v), 1)))
        seed = np.tile(v, (reps, 1))[:total]
        seed = seed + np.random.default_rng(0).normal(scale=1e-3,
                                                      size=seed.shape)
        self._h_centroids = seed.astype(np.float32)

    def _place(self, key, vec: np.ndarray, shard: int, cell: int) -> None:
        """Slot-allocation invariant lives HERE only: a free slot in the
        chosen (shard, cell), growing on overflow, then cells/valid/key
        maps/shard counts updated together."""
        gcell = shard * self.n_cells + cell
        free = np.nonzero(~self._h_valid[gcell])[0]
        if len(free) == 0:
            self._grow_cells()
            free = np.nonzero(~self._h_valid[gcell])[0]
        slot = int(free[0])
        self._h_cells[gcell, slot] = vec
        self._h_valid[gcell, slot] = True
        g = gcell * self.cell_cap + slot
        self._key_of[g] = key
        self._loc[key] = g
        self._shard_count[shard] += 1

    def _insert_batch(self, keys: list, vecs: np.ndarray) -> None:
        """Batched insert: shards chosen so final loads balance, then ONE
        centroid gemm per shard assigns cells (vs a per-vector gemm)."""
        counts = list(self._shard_count)
        shards = np.empty(len(keys), dtype=np.int64)
        for i in range(len(keys)):
            s = int(np.argmin(counts))
            counts[s] += 1
            shards[i] = s
        for s in np.unique(shards):
            idx = np.nonzero(shards == s)[0]
            c0 = int(s) * self.n_cells
            cents = self._h_centroids[c0 : c0 + self.n_cells]
            block = vecs[idx]
            if self.metric == "l2":
                d2 = (
                    np.sum(block * block, axis=1, keepdims=True)
                    + np.sum(cents * cents, axis=1)[None, :]
                    - 2.0 * block @ cents.T
                )
                cells = np.argmin(d2, axis=1)
            else:
                cells = np.argmax(block @ cents.T, axis=1)
            for j, i in enumerate(idx):
                self._place(keys[int(i)], vecs[int(i)], int(s), int(cells[j]))

    def add(self, keys: list, vectors) -> None:
        if not keys:
            return
        v = self._prep(vectors)
        self._seed(v)
        if len(set(keys)) != len(keys):
            # duplicate keys in one batch: last occurrence wins (upsert)
            last = {k: i for i, k in enumerate(keys)}
            keep = sorted(last.values())
            keys = [keys[i] for i in keep]
            v = v[keep]
        existing = [k for k in keys if k in self._loc]
        if existing:
            self.remove(existing)
        self._insert_batch(keys, v)
        if not self._trained:
            self._pending.append(v)
            self._maybe_train()
        self._dev = None  # host state changed; re-upload on next search

    def _fit_shards(self, sample: np.ndarray, per: int) -> None:
        """Per-shard k-means on the rows that shard owns (every dp-th row
        of ``sample``, at most ``per``), on shard 0's device."""
        dev = self.mesh.devices[0]
        for shard in range(self.dp):
            c0 = shard * self.n_cells
            rows = sample[shard :: self.dp][:per]
            if len(rows) == 0:
                continue
            self._h_centroids[c0 : c0 + self.n_cells] = kmeans_fit(
                torch.as_tensor(rows, dtype=torch.float32, device=dev),
                torch.as_tensor(self._h_centroids[c0 : c0 + self.n_cells], device=dev),
            ).cpu().numpy()

    def _train_from(self, v: np.ndarray) -> None:
        """Train centroids from an incoming sample (classic IVF build
        order: train, then add) instead of waiting for ``train_after``."""
        self._fit_shards(v, self.train_after * 4)
        self._trained = True
        self._pending.clear()
        if self._loc:
            # rows placed before training sit in seed-centroid cells;
            # re-place them under the trained centroids
            self._rebuild()

    def _balanced_quotas(self, n: int) -> np.ndarray:
        """Rows-per-shard so the FINAL loads are as level as possible
        (water filling): find the lowest level L whose fill capacity
        covers ``n``, fill every shard to L-1, then hand the leftover to
        the shards still below L. Equivalent to n iterations of
        argmin(counts) without the per-row Python loop."""
        counts = np.asarray(self._shard_count, np.int64)
        lo, hi = int(counts.min()), int(counts.max()) + n
        while lo < hi:
            mid = (lo + hi) // 2
            if int(np.maximum(0, mid - counts).sum()) >= n:
                hi = mid
            else:
                lo = mid + 1
        quota = np.maximum(0, (lo - 1) - counts)
        leftover = n - int(quota.sum())
        elig = np.nonzero(counts + quota < lo)[0]
        quota[elig[:leftover]] += 1
        return quota

    def add_bulk(self, keys: list, vectors, chunk: int = 65536) -> None:
        """Bulk build for multi-million-row loads: everything per-row in
        :meth:`add` becomes per-cell or per-chunk.

        * shard choice: closed-form water filling (``_balanced_quotas``)
          instead of an argmin per vector;
        * cell choice: chunked ``block @ centroids.T`` argmax, bounding the
          score temp at ``chunk x n_cells`` floats;
        * slot packing: rows grouped by destination cell (one stable sort),
          then each touched cell takes a contiguous run of its free slots —
          at most ``n_cells`` Python iterations per shard, not one per row.

        Untrained indexes train from the incoming sample first (build-time
        k-means), so no post-hoc rebuild is needed. Falls back to
        :meth:`add` for upserts/duplicates, where per-key handling is the
        point."""
        if not keys:
            return
        if len(set(keys)) != len(keys) or any(k in self._loc for k in keys):
            self.add(keys, vectors)
            return
        v = self._prep(vectors)
        self._seed(v)
        if not self._trained:
            self._train_from(v)
        quota = self._balanced_quotas(len(keys))
        start = 0
        for s in range(self.dp):
            m = int(quota[s])
            if m == 0:
                continue
            block = v[start : start + m]
            bkeys = keys[start : start + m]
            start += m
            c0 = s * self.n_cells
            cents = self._h_centroids[c0 : c0 + self.n_cells]
            cells = np.empty(m, np.int64)
            for o in range(0, m, chunk):
                blk = block[o : o + chunk]
                if self.metric == "l2":
                    d2 = (
                        np.sum(blk * blk, axis=1, keepdims=True)
                        + np.sum(cents * cents, axis=1)[None, :]
                        - 2.0 * blk @ cents.T
                    )
                    cells[o : o + len(blk)] = np.argmin(d2, axis=1)
                else:
                    cells[o : o + len(blk)] = np.argmax(blk @ cents.T, axis=1)
            order = np.argsort(cells, kind="stable")
            sorted_cells = cells[order]
            uniq, first = np.unique(sorted_cells, return_index=True)
            bounds = np.append(first, m)
            for ui in range(len(uniq)):
                rows = order[bounds[ui] : bounds[ui + 1]]
                gcell = c0 + int(uniq[ui])
                free = np.nonzero(~self._h_valid[gcell])[0]
                while len(free) < len(rows):
                    self._grow_cells()
                    free = np.nonzero(~self._h_valid[gcell])[0]
                slots = free[: len(rows)]
                self._h_cells[gcell, slots] = block[rows]
                self._h_valid[gcell, slots] = True
                g = (gcell * self.cell_cap + slots).tolist()
                kk = [bkeys[r] for r in rows.tolist()]
                self._key_of.update(zip(g, kk))
                self._loc.update(zip(kk, g))
            self._shard_count[s] += m
        self._dev = None

    def _grow_cells(self) -> None:
        new_cap = self.cell_cap * 2
        cells = np.zeros(
            (self._h_cells.shape[0], new_cap, self.dim), np.float32
        )
        valid = np.zeros((self._h_valid.shape[0], new_cap), bool)
        cells[:, : self.cell_cap] = self._h_cells
        valid[:, : self.cell_cap] = self._h_valid
        remap = {}
        for g, key in self._key_of.items():
            gcell, slot = divmod(g, self.cell_cap)
            remap[gcell * new_cap + slot] = key
        self._key_of = remap
        self._loc = {k: g for g, k in remap.items()}
        self._h_cells, self._h_valid = cells, valid
        self.cell_cap = new_cap

    def _maybe_train(self) -> None:
        if self._trained or len(self._loc) < self.train_after * self.dp:
            return
        self._fit_shards(np.concatenate(self._pending), self.train_after * 4)
        self._trained = True
        self._pending.clear()
        self._rebuild()

    def _rebuild(self) -> None:
        items = list(self._loc.items())
        vecs = np.stack(
            [
                self._h_cells[g // self.cell_cap, g % self.cell_cap]
                for _, g in items
            ]
        ) if items else np.zeros((0, self.dim), np.float32)
        keys = [k for k, _ in items]
        self._h_cells[:] = 0.0
        self._h_valid[:] = False
        self._key_of.clear()
        self._loc.clear()
        self._shard_count = [0] * self.dp
        # re-add without re-normalizing (vectors are already prepped)
        if keys:
            self._insert_batch(keys, vecs)
        self._dev = None

    def remove(self, keys: list) -> None:
        for key in keys:
            g = self._loc.pop(key, None)
            if g is None:
                continue
            gcell, slot = divmod(g, self.cell_cap)
            self._h_valid[gcell, slot] = False
            self._key_of.pop(g, None)
            self._shard_count[gcell // self.n_cells] -= 1
        self._dev = None

    def _device_state(self):
        if self._dev is None:
            dev = self.mesh.devices[0]
            self._dev = tuple(
                _row_sharded(torch.as_tensor(a, device=dev).to(dt), self.mesh)
                for a, dt in ((self._h_cells, self.dtype), (self._h_valid, torch.bool),
                              (self._h_centroids, torch.float32)))
        return self._dev

    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        if len(self._loc) == 0:
            q = np.asarray(queries)
            nq = 1 if q.ndim == 1 else len(q)
            record_retrieval_backend("sharded_ivf", nq)
            return [[] for _ in range(nq)]
        q = self._prep(queries)
        nq = len(q)
        record_retrieval_backend("sharded_ivf", nq)
        bucket = next_pow2(nq, 16)
        if bucket > nq:
            q = np.concatenate([q, np.zeros((bucket - nq, self.dim), np.float32)])
        cells, valid, cents = self._device_state()
        sc, gslots = sharded_ivf_topk_merge(
            self.mesh, cells, valid, cents,
            torch.as_tensor(q, device=self.mesh.devices[0]), k, self.nprobe, self.metric)
        sc, gslots = sc.cpu().numpy(), gslots.cpu().numpy()
        out = []
        for qi in range(nq):
            row = []
            for j in range(sc.shape[1]):
                s = float(sc[qi, j])
                if s <= _NEG_INF / 2:
                    continue
                key = self._key_of.get(int(gslots[qi, j]))
                if key is not None:
                    row.append((key, s))
                if len(row) >= k:
                    break
            out.append(row)
        return out
