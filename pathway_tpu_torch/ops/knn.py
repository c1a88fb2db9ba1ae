"""Brute-force KNN on the card: a device-resident corpus, one gemm and a
top-k (counterpart of ``pathway_tpu/ops/knn.py``).

* The corpus is a capacity-doubling padded matrix on the device. The port
  writes appended and moved rows IN PLACE (the JAX package rebuilds its
  donated buffers); only real rows are written, so padding never forces
  the capacity to grow.
* Scores follow the JAX numerics: queries rounded to bf16 against the
  (bf16-stored) corpus with float32 products and sums. A bf16 torch
  matmul would round its output to bf16, so both bf16 operands are upcast
  and multiplied in f32 — every product of two bf16 values is exact in
  f32, which leaves only the summation order to differ.
* Top-k breaks ties toward the lower index, as ``lax.top_k`` does: a
  stable descending sort, never ``torch.topk``'s unspecified tie order.
  (One difference remains: ``lax.top_k`` ranks +0.0 above -0.0, the sort
  treats them as equal.)
* Deletes are O(1) swaps with the last row (the index is unordered).
* Appends, searches and drains count device dispatches
  (``engine/probes.record_device_dispatch``), and the host key bookkeeping
  of an append is the ``append`` stage, as in JAX.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.engine.probes import record_device_dispatch, record_stage
from pathway_tpu_torch.ops import canonical_metric, next_pow2, prep_host_vectors

_NEG_INF = -1e30


def knn_scores(corpus, valid_mask, queries, metric: str,
               f32_scores: bool = False):
    """Masked similarity scores, higher is better. corpus (N, d), queries
    (Q, d) -> (Q, N) float32; invalid rows score ``_NEG_INF``.

    Default: queries rounded to bf16, corpus as stored, products and sums
    in f32. ``f32_scores=True`` keeps the queries in f32."""
    c = corpus.float()
    if f32_scores:
        q = queries.float()
    else:
        q = queries.to(torch.bfloat16).float()
    dots = q @ c.T  # (Q, N)
    if metric == "l2":
        qn = queries.float().square().sum(dim=1, keepdim=True)
        cn = c.square().sum(dim=1)[None, :]
        scores = -(qn + cn - 2.0 * dots)  # negative squared L2
    else:  # cosine / dot on normalized vectors
        scores = dots
    return torch.where(valid_mask[None, :], scores, _NEG_INF)


def _normalize(v):
    """Unit-normalise rows (zero vectors map to ~0, not NaN)."""
    return v / v.norm(dim=1, keepdim=True).clamp(min=1e-9)


_TOPK_BLOCK = 8192


def _topk_stable(scores, k: int):
    """Top-k along the last axis, ties to the lower index."""
    idx = torch.argsort(scores, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(scores, -1, idx), idx


def topk_scores(scores, k: int):
    """top-k over (Q, N) scores -> (values (Q, k), indices (Q, k)).

    For N > 2 * _TOPK_BLOCK a two-stage blocked reduction, as in the JAX
    package: per-block top-k, then top-k over the block winners. A ragged
    tail pads the last block with ``_NEG_INF``, which never wins against a
    real score. Both stages keep the lower-index-first tie order, so the
    result equals a single stable top-k over the row."""
    Q, N = scores.shape
    if N <= 2 * _TOPK_BLOCK:
        return _topk_stable(scores, k)
    pad = (-N) % _TOPK_BLOCK
    if pad:
        scores = torch.cat(
            [scores, scores.new_full((Q, pad), _NEG_INF)], dim=1
        )
    nb = (N + pad) // _TOPK_BLOCK
    kb = min(k, _TOPK_BLOCK)
    bs, bi = _topk_stable(scores.reshape(Q, nb, _TOPK_BLOCK), kb)
    fs, fi = _topk_stable(bs.reshape(Q, nb * kb), k)
    within = torch.gather(bi.reshape(Q, nb * kb), 1, fi)
    return fs, torch.div(fi, kb, rounding_mode="floor") * _TOPK_BLOCK + within


def search_corpus(corpus, valid, queries, k: int, metric: str,
                  normalize: bool = False, f32_scores: bool = False):
    """Score queries against the corpus and take the top k."""
    q = queries.float()
    if normalize:
        q = _normalize(q)
    return topk_scores(
        knn_scores(corpus, valid, q, metric, f32_scores=f32_scores), k
    )


class BruteForceKnnIndex:
    """Single-device KNN index. ``device=None`` means CUDA (raises
    without it); ``device="cpu"`` runs on the CPU."""

    def __init__(
        self,
        dimensions: int,
        reserved_space: int = 1024,
        metric: str = "cos",
        dtype=torch.bfloat16,
        f32_scores: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dimensions
        self.metric = canonical_metric(metric)
        self.f32_scores = bool(f32_scores)
        self.capacity = next_pow2(reserved_space, 16)
        self.dtype = dtype
        self._corpus = torch.zeros((self.capacity, self.dim), dtype=dtype,
                                   device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.bool,
                                  device=self.device)
        self.n = 0
        self._keys: list[Any] = []
        self._slot_of: dict[Any, int] = {}

    # ------------------------------------------------------------------ sizing
    def _grow(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        corpus = self._corpus.new_zeros((new_cap, self.dim))
        corpus[: self.capacity] = self._corpus
        valid = self._valid.new_zeros((new_cap,))
        valid[: self.capacity] = self._valid
        self._corpus, self._valid = corpus, valid
        self.capacity = new_cap

    # ------------------------------------------------------------------ update
    def _append(self, keys: list, v: torch.Tensor, normalize: bool,
                kind: str = "knn_append") -> None:
        """Write ``v`` (m, d) at the cursor, in place, and mark it valid:
        one device dispatch of ``kind``."""
        m = len(keys)
        self._grow(self.n + m)
        v = v[:m].float()
        if normalize:
            v = _normalize(v)
        start = self.n
        self._corpus[start : start + m] = v.to(self.dtype)
        self._valid[start : start + m] = True
        record_device_dispatch(kind)
        self._record_keys(keys, start)

    def _record_keys(self, keys: list, start: int) -> None:
        """The host half of an append (key -> slot), timed as the
        ``append`` stage."""
        t0 = time.perf_counter()
        self._slot_of.update(zip(keys, range(start, start + len(keys))))
        self._keys.extend(keys)
        self.n += len(keys)
        record_stage("append", time.perf_counter() - t0)

    def add(self, keys: list, vectors) -> None:
        """Host vectors (unit-normalised here for cosine)."""
        if not keys:
            return
        v = torch.from_numpy(prep_host_vectors(vectors, self.metric))
        self._append(keys, v.to(self.device), normalize=False)

    def add_device(self, keys: list, vectors: torch.Tensor) -> None:
        """Vectors already on the device (e.g. from the embedder)."""
        if not keys:
            return
        v = vectors if vectors.dim() == 2 else vectors[None, :]
        self._append(keys, v, normalize=self.metric == "cos")

    def add_embed(self, keys: list, params, input_ids, attention_mask,
                  cfg, embed, pad_id: int = 0, query_rows: int = 0,
                  k: int = 0):
        """Embed a tokenized batch and append its first ``len(keys)`` rows.
        ``embed(params, ids, mask, cfg)`` returns unit-normalized (rows, d)
        float32. ``attention_mask=None`` derives the mask as
        ``input_ids != pad_id``. Returns the embeddings.

        ``query_rows=q, k=n`` also searches the first ``q`` fresh
        embeddings against the corpus as updated by this append and
        returns ``(emb, scores, idx)``."""
        m = len(keys)
        if m == 0:
            return (None, None, None) if query_rows else None
        rows = input_ids.shape[0]
        if rows < m:
            raise ValueError(f"{m} keys but only {rows} token rows")
        if query_rows:
            if k < 1:
                raise ValueError(
                    f"query_rows={query_rows} requires k >= 1 (got {k})"
                )
            if not 0 <= query_rows <= rows:
                raise ValueError(
                    f"query_rows={query_rows} must be within the {rows} "
                    f"token rows"
                )
        if attention_mask is None:
            attention_mask = (input_ids != pad_id).to(torch.int32)
        emb = embed(params, input_ids, attention_mask, cfg)
        self._append(keys, emb, normalize=False,
                     kind="knn_embed_append_query" if query_rows else "knn_embed_append")
        if not query_rows:
            return emb
        scores, idx = search_corpus(
            self._corpus, self._valid, emb[:query_rows],
            min(k, self.capacity), self.metric, f32_scores=self.f32_scores,
        )
        return emb, scores, idx

    def remove(self, keys: list) -> None:
        """Swap each removed row with the last live row, in place."""
        for key in keys:
            slot = self._slot_of.pop(key, None)
            if slot is None:
                continue
            last = self.n - 1
            if slot != last:
                last_key = self._keys[last]
                self._corpus[slot] = self._corpus[last]
                self._keys[slot] = last_key
                self._slot_of[last_key] = slot
            self._valid[last] = False
            self._keys.pop()
            self.n -= 1

    # ------------------------------------------------------------------ search
    def search_device(self, queries, k: int):
        """Search without a host sync: device ``(scores (Q, k), idx (Q, k))``."""
        q = queries
        if not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.asarray(q, dtype=np.float32))
        q = q.to(self.device)
        if q.dim() == 1:
            q = q[None, :]
        out = search_corpus(
            self._corpus, self._valid, q, min(k, self.capacity), self.metric,
            normalize=self.metric == "cos", f32_scores=self.f32_scores,
        )
        record_device_dispatch("knn_search")
        return out

    def resolve(self, scores, idx, nq: int, k: int) -> list[list[tuple[Any, float]]]:
        """Map fetched (host) score/index arrays back to [(key, score)] rows."""
        scores = np.asarray(scores)[:nq]
        idx = np.asarray(idx)[:nq]
        out = []
        for qi in range(nq):
            row = []
            for j in range(scores.shape[1]):
                s = float(scores[qi, j])
                if s <= _NEG_INF / 2:
                    break
                slot = int(idx[qi, j])
                if slot < len(self._keys):
                    row.append((self._keys[slot], s))
            out.append(row)
        return out

    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        """Return per-query [(key, score)] sorted by decreasing score."""
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries, dtype=np.float32)
        nq = 1 if queries.ndim == 1 else queries.shape[0]
        if self.n == 0:
            return [[] for _ in range(nq)]
        scores, idx = self.search_device(queries, k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        record_device_dispatch("knn_drain")
        return self.resolve(scores, idx, nq, k)

    def __len__(self) -> int:
        return self.n
