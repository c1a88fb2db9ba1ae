"""IVF-Flat approximate KNN on the card (counterpart of
``pathway_tpu/ops/ivf.py``).

Cluster the corpus into ``n_cells`` centroids (k-means, blocked matrix
products), store the vectors cell-major on the device, and search by
scoring the query against the centroids, taking the top ``nprobe`` cells
and running the exact product and top-k over those cells' members only.
Work drops by about ``n_cells / nprobe`` against brute force, at a recall
that nprobe governs.

Layout: ``(n_cells, cell_capacity, d)`` in bf16 (default), f32 or int8
(with a per-slot f32 scale), plus a validity mask. Appends write their
(cell, slot) positions in place (``index_put_``); deletes invalidate
slots, which go to per-cell free lists. A row spills to the next-nearest
of its candidate cells when its best cell is full; cell capacity doubles
only when every candidate is full.

JAX leaves all of this to XLA, so it is plain torch ops. The numerics
follow JAX's: f32 k-means and centroid scores (TF32 must stay off on the
card), queries rounded to bf16 against bf16 or f32 cells with f32
products, int8 cells scored from symmetric-quantized queries with exact
integer dot products (accumulated in f32 while ``d * 127**2 < 2**24``,
else f64) rescaled by both scales. Every top-k breaks ties toward the
lower index, as ``lax.top_k`` does (``ops/knn.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.engine.probes import record_retrieval_backend
from pathway_tpu_torch.ops import canonical_metric, next_pow2, prep_host_vectors
from pathway_tpu_torch.ops.knn import _topk_stable, topk_scores

_NEG_INF = -1e30
# a row tries up to its 32 nearest cells (capped at nprobe per index, see
# _insert) before every cell's capacity doubles: spilled rows stay
# findable, since a row's cell is among its own top-nprobe cells
_SPILL_CANDIDATES = 32
# rows a cell-assignment block scores at once: bounds the (block, n_cells)
# score matrix whatever the size of an insert batch
_ASSIGN_BLOCK = 8192
# bytes of gathered candidates a search materialises at once (queries are
# chunked to stay under it; each query's result is independent of the rest)
_SEARCH_CHUNK_BYTES = 1 << 30


def kmeans_fit(vectors: torch.Tensor, centroids0: torch.Tensor,
               n_iters: int = 10, block: int = 8192) -> torch.Tensor:
    """k-means over ``vectors`` (N, d) f32 from ``centroids0`` (C, d);
    returns the refined (C, d) f32 centroids. A centroid no row picks
    keeps its position. Assignment and accumulation run over blocks of
    ``block`` rows, so the (rows, C) temporaries stay (block, C); the
    per-cell sums are one-hot products, as in JAX (deterministic on the
    card, unlike atomic scatters)."""
    n, dim = vectors.shape
    c = centroids0.shape[0]
    pad = (-n) % block
    v_all = vectors.float()
    if pad:
        v_all = torch.cat([v_all, v_all.new_zeros((pad, dim))])
    weights = (torch.arange(n + pad, device=v_all.device) < n).float()
    centroids = centroids0.float()
    for _ in range(n_iters):
        c_norm = (centroids * centroids).sum(dim=1)[None, :]
        sums = v_all.new_zeros((c, dim))
        counts = v_all.new_zeros((c,))
        for s in range(0, n + pad, block):
            v, w = v_all[s : s + block], weights[s : s + block]
            scores = v @ centroids.T
            n_norm = (v * v).sum(dim=1, keepdim=True)
            assign = torch.argmin(n_norm + c_norm - 2.0 * scores, dim=1)
            oh = torch.nn.functional.one_hot(assign, c).float() * w[:, None]
            sums = sums + oh.T @ v
            counts = counts + oh.sum(dim=0)
        counts = counts[:, None]
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1.0), centroids)
    return centroids


def _assign_cells_block(v, centroids, metric: str, top_c: int = _SPILL_CANDIDATES):
    scores = v @ centroids.T
    if metric == "l2":
        vn = (v * v).sum(dim=1, keepdim=True)
        cn = (centroids * centroids).sum(dim=1)[None, :]
        scores = -(vn + cn - 2.0 * scores)
    _, idx = _topk_stable(scores, min(top_c, centroids.shape[0]))
    return idx.to(torch.int32)


def _assign_cells(v, centroids, metric: str, top_c: int = _SPILL_CANDIDATES):
    """The ``top_c`` nearest centroids of each row, (m, top_c) int32, best
    first: a row spills down this list when its best cell is full.
    Blocked over rows, so any batch size keeps a bounded score matrix."""
    m = v.shape[0]
    if m <= _ASSIGN_BLOCK:
        return _assign_cells_block(v, centroids, metric, top_c)
    return torch.cat([
        _assign_cells_block(v[s : s + _ASSIGN_BLOCK], centroids, metric, top_c)
        for s in range(0, m, _ASSIGN_BLOCK)
    ])


def _write_slots(cells, valid, vecs, cell_arr, slot_arr, scales=None) -> None:
    """Write a whole append batch in place: ``vecs`` (m, d) at positions
    (cell_arr[i], slot_arr[i]), marked valid. With ``scales`` (int8
    cells) each row is symmetric-quantized first: s = max|v| / 127,
    q = round(v / s), the scale written to the parallel (C, cap) plane."""
    pos = (cell_arr.long(), slot_arr.long())
    if scales is not None:
        v = vecs.float()
        s = torch.clamp(v.abs().amax(dim=1) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(v / s[:, None]), -127, 127).to(torch.int8)
        cells.index_put_(pos, q)
        scales.index_put_(pos, s.to(scales.dtype))
    else:
        cells.index_put_(pos, vecs.to(cells.dtype))
    valid.index_put_(pos, torch.ones_like(pos[0], dtype=torch.bool))


def _score_members(q, cand, cand_valid, metric: str, cand_scales=None):
    """(Q, np, cap) member scores of queries ``q`` (Q, d) f32 against their
    gathered cells ``cand`` (Q, np, cap, d); invalid slots ``_NEG_INF``."""
    if cand_scales is not None:
        qs = torch.clamp(q.abs().amax(dim=1) / 127.0, min=1e-12)
        qi = torch.clamp(torch.round(q / qs[:, None]), -127, 127)
        # integer products, exact in the accumulator chosen
        acc = torch.float32 if q.shape[1] * 127 * 127 < 2 ** 24 else torch.float64
        di = torch.einsum("qd,qpcd->qpc", qi.to(acc), cand.to(acc)).float()
        cs = cand_scales.float()
        dots = di * qs[:, None, None] * cs
    else:
        dots = torch.einsum("qd,qpcd->qpc", q.to(torch.bfloat16).float(), cand.float())
    if metric == "l2":
        qn = (q * q).sum(dim=1)[:, None, None]
        if cand_scales is not None:
            cn = ((cand.float() * cs[..., None]) ** 2).sum(dim=3)
        else:
            cn = (cand.float() ** 2).sum(dim=3)
        scores = -(qn + cn - 2.0 * dots)
    else:
        scores = dots
    return torch.where(cand_valid, scores, _NEG_INF)


def _ivf_search(cells, valid, centroids, queries, k: int, nprobe: int,
                metric: str, scales=None):
    """queries (Q, d) -> (scores (Q, k), cell_ids (Q, k), slots (Q, k)).

    Score the centroids, take each query's top ``nprobe`` cells, score
    their members (the query axis in chunks that bound the gathered
    candidates) and take the top k over the probed slots."""
    q = queries.float()
    if metric == "l2":
        qn = (q * q).sum(dim=1, keepdim=True)
        cn = (centroids * centroids).sum(dim=1)[None, :]
        cent_scores = -(qn + cn - 2.0 * (q @ centroids.T))
    else:
        cent_scores = q @ centroids.T
    _, probe = _topk_stable(cent_scores, nprobe)                 # (Q, nprobe)
    Q = q.shape[0]
    cap, d = cells.shape[1], cells.shape[2]
    per_query = nprobe * cap * d * 8
    step = max(1, _SEARCH_CHUNK_BYTES // max(per_query, 1))
    parts = []
    for s in range(0, Q, step):
        p = probe[s : s + step]
        parts.append(_score_members(
            q[s : s + step], cells[p], valid[p], metric,
            None if scales is None else scales[p]))
    scores = torch.cat(parts)                                    # (Q, np, cap)
    flat = scores.reshape(Q, nprobe * cap)
    top_scores, flat_idx = topk_scores(flat, k)                  # (Q, k)
    probe_idx = torch.div(flat_idx, cap, rounding_mode="floor")
    slots = flat_idx % cap
    cell_ids = torch.gather(probe, 1, probe_idx)
    return top_scores, cell_ids, slots


class IvfFlatIndex:
    """Single-device IVF-Flat ANN index. ``dtype`` is the cells' storage:
    ``torch.bfloat16`` (default), ``torch.float32`` or ``torch.int8``.
    ``device=None`` means CUDA (raises without it); ``device="cpu"`` runs
    on the CPU. The other defaults are JAX's."""

    def __init__(
        self,
        dimensions: int,
        n_cells: int = 64,
        nprobe: int = 8,
        metric: str = "cos",
        cell_capacity: int = 64,
        train_after: int | None = None,
        dtype=torch.bfloat16,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dimensions
        self.metric = canonical_metric(metric)
        self.n_cells = n_cells
        self.nprobe = min(nprobe, n_cells)
        # a multiple of 16, not a power of two: capacity budgets are sized
        # against this, the dominant device tensor
        self.cell_cap = max(16, -(-int(cell_capacity) // 16) * 16)
        self.dtype = dtype
        # train once this many vectors have arrived (None: n_cells * 16)
        self.train_after = n_cells * 16 if train_after is None else train_after
        self._trained = False
        self._cells = torch.zeros((n_cells, self.cell_cap, dimensions), dtype=dtype,
                                  device=self.device)
        # int8 cells: the per-slot scale (a member is q * scale)
        self._scales = (torch.zeros((n_cells, self.cell_cap), dtype=torch.float32,
                                    device=self.device)
                        if dtype == torch.int8 else None)
        self._valid = torch.zeros((n_cells, self.cell_cap), dtype=torch.bool,
                                  device=self.device)
        self._centroids: torch.Tensor | None = None  # (C, d) f32, seeded lazily
        self.n = 0
        self._keys: dict[tuple[int, int], Any] = {}   # (cell, slot) -> key
        self._loc: dict[Any, tuple[int, int]] = {}    # key -> (cell, slot)
        self._fill: list[int] = [0] * n_cells         # next never-used slot
        self._free: list[list[int]] = [[] for _ in range(n_cells)]
        # pre-training vectors and their keys, kept where they came from
        # (host arrays for add, device tensors for add_device): the rebuild
        # after training re-inserts from here without reading the cells back
        self._pending: list = []
        self._pending_keys: list[list] = []

    # ------------------------------------------------------------- internals
    def _prep(self, vectors) -> np.ndarray:
        return prep_host_vectors(vectors, self.metric)

    @staticmethod
    def _on_device(v) -> bool:
        return isinstance(v, torch.Tensor)

    def _to_device(self, v) -> torch.Tensor:
        if self._on_device(v):
            return v.to(self.device)
        return torch.from_numpy(np.asarray(v, dtype=np.float32)).to(self.device)

    def _seed_centroids(self, v) -> None:
        if self._centroids is not None:
            return
        reps = int(np.ceil(self.n_cells / max(len(v), 1)))
        jitter = np.random.default_rng(0).normal(
            scale=1e-3, size=(self.n_cells, self.dim)).astype(np.float32)
        if self._on_device(v):
            seed = v.repeat(reps, 1)[: self.n_cells].float()
            self._centroids = seed + torch.from_numpy(jitter).to(self.device)
        else:
            seed = np.tile(v, (reps, 1))[: self.n_cells]
            self._centroids = torch.from_numpy(
                (seed + jitter).astype(np.float32)).to(self.device)

    def _maybe_train(self) -> None:
        if self._trained or self.n < self.train_after:
            return
        if any(self._on_device(p) for p in self._pending):
            sample = torch.cat([self._to_device(p) for p in self._pending])
        else:
            sample = self._to_device(np.concatenate(self._pending))
        sample = sample[-self.train_after * 4:]
        self._centroids = kmeans_fit(sample.float(), self._centroids)
        del sample  # before the rebuild, which wants the memory
        self._trained = True
        self._rebuild()

    def _rebuild(self) -> None:
        """Re-assign every pre-training vector to the trained centroids,
        from the pending copies. The latest copy of a key wins, and keys
        removed since are dropped."""
        if not self._pending:
            return
        latest: dict[Any, tuple[int, int]] = {}
        for ai, ks in enumerate(self._pending_keys):
            for ri, k in enumerate(ks):
                latest[k] = (ai, ri)
        if any(self._on_device(p) for p in self._pending):
            live = set(self._loc)
            chunks, keysets = self._pending, self._pending_keys
            self._pending, self._pending_keys = [], []
            self._reset_cells()
            for ai, (chunk, ks) in enumerate(zip(chunks, keysets)):
                sel = [ri for ri, k in enumerate(ks)
                       if k in live and latest[k] == (ai, ri)]
                if not sel:
                    continue
                rows = torch.tensor(sel, dtype=torch.long, device=self.device)
                self._insert([ks[ri] for ri in sel], self._to_device(chunk)[rows],
                             record_pending=False)
            return
        keys = [k for k in latest if k in self._loc]
        vecs = (np.stack([self._pending[latest[k][0]][latest[k][1]] for k in keys])
                if keys else np.zeros((0, self.dim), np.float32))
        self._pending.clear()
        self._pending_keys.clear()
        self._reset_cells()
        if keys:
            self._insert(keys, vecs, record_pending=False)

    def _reset_cells(self) -> None:
        # zeroed in place: a fresh tensor would briefly double the cells
        self._cells.zero_()
        self._valid.zero_()
        if self._scales is not None:
            self._scales.zero_()
        self._keys.clear()
        self._loc.clear()
        self._fill = [0] * self.n_cells
        self._free = [[] for _ in range(self.n_cells)]
        self.n = 0

    def _grow_cells(self) -> None:
        new_cap = self.cell_cap * 2
        new_bytes = (self.n_cells * new_cap * self.dim
                     * torch.empty((), dtype=self.dtype).element_size())
        if new_bytes > 7 << 30:
            # the grow holds old and new cells at once
            raise RuntimeError(
                f"IVF cell capacity exhausted at {self.n} rows "
                f"(n_cells={self.n_cells}, cell_capacity={self.cell_cap}, "
                f"spill={_SPILL_CANDIDATES}): growing would need "
                f"{new_bytes / (1 << 30):.1f} GiB; raise cell_capacity "
                f"or n_cells up front")
        cells = self._cells.new_zeros((self.n_cells, new_cap, self.dim))
        cells[:, : self.cell_cap] = self._cells
        valid = self._valid.new_zeros((self.n_cells, new_cap))
        valid[:, : self.cell_cap] = self._valid
        if self._scales is not None:
            scales = self._scales.new_zeros((self.n_cells, new_cap))
            scales[:, : self.cell_cap] = self._scales
            self._scales = scales
        self._cells, self._valid = cells, valid
        self.cell_cap = new_cap

    def _alloc_slot(self, cell: int) -> int | None:
        """Next free slot of ``cell``, or None when it is full (the caller
        spills to the next candidate cell)."""
        if self._free[cell]:
            return self._free[cell].pop()
        if self._fill[cell] >= self.cell_cap:
            return None
        slot = self._fill[cell]
        self._fill[cell] += 1
        return slot

    def _insert(self, keys: list, v, record_pending: bool = True) -> None:
        self._seed_centroids(v)
        # spill reach is capped at nprobe: a row in its rank-k cell is
        # found only by queries probing >= k cells
        top_c = max(4, min(_SPILL_CANDIDATES, self.nprobe))
        dev_v = self._to_device(v).float()
        cand = _assign_cells(dev_v, self._centroids, self.metric, top_c=top_c)
        cand = cand.cpu().numpy()
        if any(self._free):
            cells_used, slots = self._alloc_rows_slow(cand)
        else:
            cells_used, slots = self._alloc_rows_bulk(cand)
        for i, key in enumerate(keys):
            cell, slot = int(cells_used[i]), int(slots[i])
            self._keys[(cell, slot)] = key
            self._loc[key] = (cell, slot)
        self.n += len(keys)
        _write_slots(self._cells, self._valid, dev_v,
                     torch.from_numpy(cells_used).to(self.device),
                     torch.from_numpy(slots).to(self.device), scales=self._scales)
        if record_pending and not self._trained:
            self._pending.append(v)
            self._pending_keys.append(list(keys))

    def _alloc_rows_slow(self, cand: np.ndarray):
        """Per-row allocation through the free lists (inserts after a
        remove)."""
        m = len(cand)
        cells_used = np.empty(m, dtype=np.int32)
        slots = np.empty(m, dtype=np.int32)
        for i in range(m):
            slot = None
            cell = int(cand[i, 0])
            for c in cand[i]:
                slot = self._alloc_slot(int(c))
                if slot is not None:
                    cell = int(c)
                    break
            if slot is None:
                # every candidate cell is full: grow every cell
                self._grow_cells()
                slot = self._alloc_slot(cell)
            cells_used[i] = cell
            slots[i] = slot
        return cells_used, slots

    def _alloc_rows_bulk(self, cand: np.ndarray):
        """Vectorised allocation for bulk builds (no free lists): per spill
        round, group rows by candidate cell and hand out consecutive slots
        up to capacity; rows left over finish on the per-row path."""
        m = len(cand)
        cells_used = np.full(m, -1, dtype=np.int32)
        slots = np.full(m, -1, dtype=np.int32)
        fill = np.asarray(self._fill, dtype=np.int64)
        remaining = np.arange(m)
        for c_idx in range(cand.shape[1]):
            if not len(remaining):
                break
            cells = cand[remaining, c_idx].astype(np.int64)
            order = np.argsort(cells, kind="stable")
            sc = cells[order]
            uniq, starts = np.unique(sc, return_index=True)
            counts = np.diff(np.append(starts, len(sc)))
            take = np.minimum(counts, np.maximum(self.cell_cap - fill[uniq], 0))
            pos = np.arange(len(sc)) - np.repeat(starts, counts)
            ok = pos < np.repeat(take, counts)
            rows = remaining[order[ok]]
            cells_used[rows] = sc[ok]
            slots[rows] = (np.repeat(fill[uniq], counts) + pos)[ok]
            fill[uniq] += take
            remaining = remaining[order[~ok]]
        self._fill = fill.tolist()
        if len(remaining):
            c2, s2 = self._alloc_rows_slow(cand[remaining])
            cells_used[remaining] = c2
            slots[remaining] = s2
        return cells_used, slots

    # ---------------------------------------------------------------- public
    def add(self, keys: list, vectors) -> None:
        """Host vectors (unit-normalised here for cosine)."""
        if not keys:
            return
        v = self._prep(vectors)
        if len(keys) != len(v):
            raise ValueError(f"{len(keys)} keys for {len(v)} vectors")
        self._insert(keys, v)
        self._maybe_train()

    def add_device(self, keys: list, vectors: torch.Tensor) -> None:
        """Vectors already on the device (e.g. from the embedder):
        normalised, assigned and written there; pre-training copies stay
        on the device too. Only the (m, spill) candidate matrix comes to
        the host."""
        if not keys:
            return
        v = vectors.to(self.device, torch.float32)
        if v.dim() == 1:
            v = v[None, :]
        if len(keys) != v.shape[0]:
            raise ValueError(f"{len(keys)} keys for {v.shape[0]} vectors")
        if self.metric == "cos":
            v = v / v.norm(dim=1, keepdim=True).clamp(min=1e-12)
        self._insert(keys, v)
        self._maybe_train()

    def remove(self, keys: list) -> None:
        cells, slots = [], []
        for key in keys:
            loc = self._loc.pop(key, None)
            if loc is None:
                continue
            cell, slot = loc
            cells.append(cell)
            slots.append(slot)
            self._keys.pop((cell, slot), None)
            self._free[cell].append(slot)
            self.n -= 1
        if cells:  # one write for the whole batch
            pos = (torch.tensor(cells, dtype=torch.long, device=self.device),
                   torch.tensor(slots, dtype=torch.long, device=self.device))
            self._valid.index_put_(pos, torch.zeros(len(cells), dtype=torch.bool,
                                                    device=self.device))

    def search_device(self, queries, k: int):
        """Search without a host sync: device ``(scores, cell_ids, slots)``
        with the query axis padded to its pow2 bucket (floor 1: the probed
        cells' gather costs a padded row as much as a real one)."""
        if self._centroids is None:
            raise ValueError(
                "search_device on an empty IvfFlatIndex (no vectors added); "
                "search() returns empty rows for this case")
        q = self._prep(queries)
        nq = len(q)
        bucket = next_pow2(nq, 1)
        if bucket > nq:
            q = np.concatenate([q, np.zeros((bucket - nq, self.dim), np.float32)])
        k_eff = min(k, self.nprobe * self.cell_cap)
        return _ivf_search(self._cells, self._valid, self._centroids,
                           torch.from_numpy(q).to(self.device), k_eff, self.nprobe,
                           self.metric, scales=self._scales)

    def resolve(self, scores, idx_cells, idx_slots, nq: int,
                k: int) -> list[list[tuple[Any, float]]]:
        """Map fetched (host) search arrays back to [(key, score)] rows."""
        scores = np.asarray(scores)
        cell_ids = np.asarray(idx_cells)
        slots = np.asarray(idx_slots)
        out = []
        for qi in range(nq):
            row = []
            for j in range(scores.shape[1]):
                s = float(scores[qi, j])
                if s <= _NEG_INF / 2:
                    break
                key = self._keys.get((int(cell_ids[qi, j]), int(slots[qi, j])))
                if key is not None:
                    row.append((key, s))
                if len(row) >= k:
                    break
            out.append(row)
        return out

    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        """Per-query [(key, score)] sorted by decreasing score."""
        if self.n == 0:
            q = np.asarray(queries)
            nq = 1 if q.ndim == 1 else len(q)
            record_retrieval_backend("ivf", nq)
            return [[] for _ in range(nq)]
        q = self._prep(queries)
        record_retrieval_backend("ivf", len(q))
        scores, cell_ids, slots = (t.cpu().numpy() for t in self.search_device(q, k))
        return self.resolve(scores, cell_ids, slots, len(q), k)

    def __len__(self) -> int:
        return self.n
