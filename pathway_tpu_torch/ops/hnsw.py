"""Host-side HNSW graph index (counterpart of ``pathway_tpu/ops/hnsw.py``).

The one module of the retrieval variants with no device work: it is host
numpy in JAX and stays host numpy here, a copy that imports nothing of the
JAX package. The IVF index (``ops/ivf.py``) is the ANN that runs on the
card; this graph index serves workloads that want HNSW semantics
(incremental insert, no training step, sub-linear host-side search with no
device round trip): a small-vector or side-table index next to a GPU
pipeline. The knobs are uSearch's (connectivity, expansion_add,
expansion_search).

Scoring batches each frontier's neighbours into one matrix-vector product.
Deletions are mask-style (uSearch semantics): removed keys stop appearing
in results; their graph nodes keep routing. The RNG draws in JAX's order
(``default_rng(seed)``, one ``random()`` an insert), so the same inserts
build the same graph.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np


class HnswIndex:
    """Hierarchical Navigable Small World graph over host vectors.

    ``connectivity`` = M (per-node degree cap above level 0; level 0
    allows 2M), ``expansion_add`` / ``expansion_search`` = ef during
    construction / query. ``metric``: "cos" (vectors unit-normalized,
    score = dot) or "l2sq" (score = -squared distance) — both
    bigger-is-better, matching ``BruteForceKnnIndex.search``.
    """

    def __init__(self, dimensions: int, metric: str = "cos",
                 connectivity: int = 16, expansion_add: int = 128,
                 expansion_search: int = 64, seed: int = 0):
        if metric not in ("cos", "l2sq", "l2"):
            metric = "cos"
        self.dim = dimensions
        self.metric = "l2sq" if metric in ("l2sq", "l2") else "cos"
        self.M = max(2, int(connectivity) or 16)
        self.M0 = 2 * self.M
        self.ef_add = max(self.M + 1, int(expansion_add) or 128)
        self.ef_search = max(1, int(expansion_search) or 64)
        self._ml = 1.0 / math.log(self.M)
        self._rng = np.random.default_rng(seed)
        self._vecs = np.empty((0, dimensions), np.float32)
        self._n = 0  # live prefix of the (geometrically grown) _vecs
        self._keys: list[Any] = []
        self._slot_of: dict[Any, int] = {}
        self._levels: list[int] = []
        # per node: list of neighbor-lists, one per level 0..node_level
        self._nbrs: list[list[list[int]]] = []
        self._deleted: set[int] = set()
        self._entry: int | None = None
        self._max_level = -1

    def __len__(self) -> int:
        return len(self._keys) - len(self._deleted)

    # ---- scoring ---------------------------------------------------------
    def _scores(self, idxs: np.ndarray, q: np.ndarray) -> np.ndarray:
        sub = self._vecs[idxs]
        if self.metric == "cos":
            return sub @ q
        d = sub - q[None, :]
        return -np.einsum("ij,ij->i", d, d)

    def _norm(self, v: np.ndarray) -> np.ndarray:
        if self.metric != "cos":
            return v
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.maximum(n, 1e-12)

    # ---- construction ----------------------------------------------------
    def add(self, keys: list, vectors) -> None:
        vecs = self._norm(np.asarray(vectors, np.float32).reshape(
            len(keys), self.dim
        ))
        start = len(self._keys)
        need = start + len(keys)
        if need > len(self._vecs):
            # geometric growth: streaming per-step adds must not copy the
            # whole matrix per batch (O(N^2) ingestion otherwise)
            cap = max(need, 2 * len(self._vecs), 1024)
            grown = np.empty((cap, self.dim), np.float32)
            grown[:start] = self._vecs[:start]
            self._vecs = grown
        self._vecs[start:need] = vecs
        self._n = need
        for off, key in enumerate(keys):
            old = self._slot_of.get(key)
            if old is not None:
                # usearch upsert semantics: the old vector stops matching
                self._deleted.add(old)
            i = start + off
            self._slot_of[key] = i
            self._keys.append(key)
            self._insert(i)

    def _insert(self, i: int) -> None:
        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self._levels.append(level)
        self._nbrs.append([[] for _ in range(level + 1)])
        if self._entry is None:
            self._entry = i
            self._max_level = level
            return
        q = self._vecs[i]
        eps = [self._entry]
        # greedy descent through levels above the node's own
        for lvl in range(self._max_level, level, -1):
            eps = [self._greedy(q, eps[0], lvl)]
        # ef-search + connect at each level the node lives on; the ef
        # result set seeds the NEXT level's search (algorithm 1, HNSW)
        for lvl in range(min(level, self._max_level), -1, -1):
            cand = self._ef_select(q, eps, lvl, self.ef_add)
            m = self.M0 if lvl == 0 else self.M
            chosen = self._select_heuristic(cand, m)
            self._nbrs[i][lvl] = list(chosen)
            for c in chosen:
                lst = self._nbrs[c][lvl]
                lst.append(i)
                cap = self.M0 if lvl == 0 else self.M
                if len(lst) > cap:
                    # re-select the over-full node's links with the same
                    # diversity heuristic (keeps long-range edges alive)
                    sc = self._scores(np.asarray(lst), self._vecs[c])
                    ranked = sorted(zip(sc.tolist(), lst), reverse=True)
                    self._nbrs[c][lvl] = self._select_heuristic(ranked, cap)
            eps = [c for _, c in cand]
        if level > self._max_level:
            self._max_level = level
            self._entry = i

    def _select_heuristic(self, cand: list[tuple[float, int]],
                          m: int) -> list[int]:
        """HNSW select-neighbors heuristic (algorithm 4): keep a candidate
        only if it is closer to the query than to every already-kept
        neighbor — preserving diverse/long-range edges instead of a
        mutually-clustered closest-m set; backfill if underfull. The
        candidate-pairwise scores come from ONE matmul (the per-pair
        loop was the construction bottleneck on host)."""
        if len(cand) <= 1:
            return [c for _, c in cand[:m]]
        ids = [c for _, c in cand]
        V = self._vecs[ids]
        if self.metric == "cos":
            pair = V @ V.T
        else:
            sq = np.einsum("ij,ij->i", V, V)
            pair = -(sq[:, None] + sq[None, :] - 2.0 * (V @ V.T))
        chosen_pos: list[int] = []
        for p, (s, _c) in enumerate(cand):
            if len(chosen_pos) >= m:
                break
            if chosen_pos and float(pair[p, chosen_pos].max()) > s:
                continue
            chosen_pos.append(p)
        if len(chosen_pos) < m:
            picked = set(chosen_pos)
            for p in range(len(cand)):
                if p not in picked:
                    chosen_pos.append(p)
                    picked.add(p)
                    if len(chosen_pos) >= m:
                        break
        return [ids[p] for p in chosen_pos]

    # ---- search ----------------------------------------------------------
    def _greedy(self, q: np.ndarray, ep: int, lvl: int) -> int:
        best = ep
        best_s = float(self._scores(np.asarray([ep]), q)[0])
        improved = True
        while improved:
            improved = False
            nb = self._nbrs[best][lvl] if lvl < len(self._nbrs[best]) else []
            if not nb:
                break
            sc = self._scores(np.asarray(nb), q)
            j = int(np.argmax(sc))
            if sc[j] > best_s:
                best, best_s = nb[j], float(sc[j])
                improved = True
        return best

    def _ef_select(self, q: np.ndarray, eps: list[int], lvl: int,
                   ef: int) -> list[tuple[float, int]]:
        """Best-first expansion keeping the top ``ef`` (score, idx),
        sorted by decreasing score. Deleted nodes still route."""
        import heapq

        seen = set(eps)
        init = self._scores(np.asarray(eps), q)
        # max-heap of frontier, min-heap of the kept set
        frontier = [(-float(s), e) for s, e in zip(init, eps)]
        heapq.heapify(frontier)
        kept = [(float(s), e) for s, e in zip(init, eps)]
        heapq.heapify(kept)
        while frontier:
            neg_s, e = heapq.heappop(frontier)
            if len(kept) >= ef and -neg_s < kept[0][0]:
                break
            nb = [
                n for n in (
                    self._nbrs[e][lvl] if lvl < len(self._nbrs[e]) else []
                )
                if n not in seen
            ]
            if not nb:
                continue
            seen.update(nb)
            sc = self._scores(np.asarray(nb), q)
            for s, n in zip(sc, nb):
                s = float(s)
                if len(kept) < ef:
                    heapq.heappush(kept, (s, n))
                    heapq.heappush(frontier, (-s, n))
                elif s > kept[0][0]:
                    heapq.heapreplace(kept, (s, n))
                    heapq.heappush(frontier, (-s, n))
        return sorted(kept, reverse=True)

    def remove(self, keys: list) -> None:
        for key in keys:
            i = self._slot_of.pop(key, None)
            if i is not None:
                self._deleted.add(i)

    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        q = self._norm(q)
        out: list[list[tuple[Any, float]]] = []
        for row in q:
            if self._entry is None:
                out.append([])
                continue
            ep = self._entry
            for lvl in range(self._max_level, 0, -1):
                ep = self._greedy(row, ep, lvl)
            ef = max(self.ef_search, k)
            cand = self._ef_select(row, [ep], 0, ef + len(self._deleted))
            hits = [
                (self._keys[i], s)
                for s, i in cand
                if i not in self._deleted
                and self._slot_of.get(self._keys[i]) == i
            ]
            out.append(hits[:k])
        return out
