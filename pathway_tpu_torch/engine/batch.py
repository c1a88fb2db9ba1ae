"""Columnar delta batches — the unit of data flowing between engine operators.

The reference moves per-row ``(key, tuple, time, diff)`` triples through
timely exchange channels (``external/differential-dataflow``). Here a batch is
a **struct-of-arrays**: a uint64 key vector, aligned value columns (typed numpy
arrays for dense numeric data, object arrays otherwise) and an int64 diff
vector, all for one logical timestamp. Dense columns can be handed to device
kernels without conversion; irregular columns stay on host.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from pathway_tpu_torch.engine import value as value_mod

class Batch:
    """A set of keyed row deltas at a single logical time."""

    __slots__ = ("keys", "cols", "diffs", "_consolidated")

    def __init__(
        self,
        keys: np.ndarray,
        cols: dict[str, np.ndarray],
        diffs: np.ndarray | None = None,
    ):
        keys = np.asarray(keys, dtype=np.uint64)
        self.keys = keys
        self.cols = cols
        if diffs is None:
            diffs = np.ones(len(keys), dtype=np.int64)
        self.diffs = np.asarray(diffs, dtype=np.int64)
        # True once a consolidate() proved this batch single-sign with
        # all-distinct keys. That invariant survives row subsetting and any
        # column transform (keys/diffs untouched), so downstream operators
        # inherit it through take/with_cols/... and their consolidate pass
        # is O(1) instead of a per-epoch np.unique sort over the spine
        # (gated by EngineConfig.epoch_closeout at the consumer).
        self._consolidated = False

    def __len__(self) -> int:
        return len(self.keys)

    def __repr__(self) -> str:
        return f"Batch(n={len(self)}, cols={list(self.cols)})"

    @property
    def column_names(self) -> list[str]:
        return list(self.cols)

    def rows(self) -> Iterable[tuple[int, tuple, int]]:
        """Iterate (key, row_tuple, diff). Columns are converted with
        ``tolist`` and zipped in C — ~3x faster than per-element numpy
        scalar extraction on row-loop-heavy operators."""
        keys = self.keys.tolist()
        diffs = self.diffs.tolist()
        col_lists = [c.tolist() for c in self.cols.values()]
        if col_lists:
            return zip(keys, zip(*col_lists), diffs)
        return zip(keys, ((),) * len(keys), diffs)

    def take(self, mask_or_idx: np.ndarray) -> "Batch":
        if mask_or_idx.dtype == bool:
            # all-true mask: skip the nonzero scan AND the per-column gather
            # copies (the hot shape — filters on streaming ingest mostly
            # pass everything). Safe to alias: batches are treated as
            # immutable by operators (consolidate only mutates fresh
            # int-indexed copies).
            if mask_or_idx.all():
                return self
            idx = np.nonzero(mask_or_idx)[0]
        else:
            idx = mask_or_idx
        out = Batch(
            self.keys[idx],
            {n: c[idx] for n, c in self.cols.items()},
            self.diffs[idx],
        )
        out._consolidated = self._consolidated  # subset of distinct keys
        return out

    def with_cols(self, cols: dict[str, np.ndarray]) -> "Batch":
        out = Batch(self.keys, cols, self.diffs)
        out._consolidated = self._consolidated  # keys/diffs untouched
        return out

    def rename(self, mapping: Mapping[str, str]) -> "Batch":
        out = Batch(
            self.keys,
            {mapping.get(n, n): c for n, c in self.cols.items()},
            self.diffs,
        )
        out._consolidated = self._consolidated
        return out

    def select_cols(self, names: list[str]) -> "Batch":
        out = Batch(self.keys, {n: self.cols[n] for n in names}, self.diffs)
        out._consolidated = self._consolidated
        return out

    def negate(self) -> "Batch":
        out = Batch(self.keys, self.cols, -self.diffs)
        out._consolidated = self._consolidated  # sign flip stays single-sign
        return out

    @staticmethod
    def empty(column_names: Iterable[str]) -> "Batch":
        return Batch(
            np.empty(0, dtype=np.uint64),
            {n: np.empty(0, dtype=object) for n in column_names},
            np.empty(0, dtype=np.int64),
        )

    @staticmethod
    def from_rows(
        column_names: list[str],
        rows: list[tuple[int, tuple, int]],
    ) -> "Batch":
        n = len(rows)
        names = list(column_names)
        if n:
            from pathway_tpu_torch import native

            keys = np.empty(n, dtype=np.uint64)
            diffs = np.empty(n, dtype=np.int64)
            try:
                col_lists = native.batch_rows_split(
                    rows if isinstance(rows, list) else list(rows),
                    len(names), keys, diffs,
                )
            except TypeError:
                pass  # list rows / odd key types: python path below
            else:
                cols = {}
                for name, cl in zip(names, col_lists):
                    a = np.empty(n, dtype=object)
                    a[:] = cl
                    cols[name] = a
                return Batch(keys, cols, diffs)
        keys = np.empty(n, dtype=np.uint64)
        diffs = np.empty(n, dtype=np.int64)
        cols = {name: np.empty(n, dtype=object) for name in names}
        for i, (k, row, d) in enumerate(rows):
            keys[i] = k
            diffs[i] = d
            for j, name in enumerate(names):
                cols[name][i] = row[j]
        return Batch(keys, cols, diffs)


def concat_batches(batches: list[Batch]) -> Batch | None:
    batches = [b for b in batches if b is not None and len(b) > 0]
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    names = batches[0].column_names
    keys = np.concatenate([b.keys for b in batches])
    diffs = np.concatenate([b.diffs for b in batches])
    cols = {}
    for n in names:
        arrays = [b.cols[n] for b in batches]
        if all(a.dtype == arrays[0].dtype and a.dtype != object for a in arrays):
            cols[n] = np.concatenate(arrays)
        else:
            cols[n] = np.concatenate([a.astype(object) for a in arrays])
    return Batch(keys, cols, diffs)


def row_hashes(batch: Batch) -> np.ndarray:
    """Per-row content hash over value columns (for consolidation grouping)."""
    return value_mod.keys_for_value_columns(
        [batch.cols[n] for n in batch.column_names], len(batch)
    )


def consolidate(batch: Batch | None, closeout: bool = True) -> Batch | None:
    """Sum diffs of identical (key, row) pairs; drop zero-diff rows (the
    groups through the C++ loop, in first-occurrence order). ``closeout``
    is the run's ``EngineConfig.epoch_closeout``."""
    if batch is None or len(batch) == 0:
        return None
    # a producer already proved this batch single-sign with distinct keys
    # (the invariant column transforms preserve) — skip even the sort-based
    # uniqueness re-check, which otherwise repeats at EVERY node of the
    # operator spine per epoch
    if batch._consolidated and closeout:
        return batch
    # insert-only (or retract-only) batch with all-distinct keys: identical
    # (key, row) pairs are impossible, so skip the per-row content hashing —
    # the common shape of every bulk-ingest commit, where hashing wide
    # object columns (e.g. embedding vectors) would dominate the epoch
    diffs = batch.diffs
    if (diffs.min() > 0 or diffs.max() < 0) and len(
        np.unique(batch.keys)
    ) == len(batch):
        batch._consolidated = True
        return batch
    from pathway_tpu_torch import native

    rh = row_hashes(batch)
    idx, summed = native.consolidate_pairs(batch.keys, rh, batch.diffs)
    if len(idx) == 0:
        return None
    if len(idx) == len(batch) and np.array_equal(summed, batch.diffs):
        return batch
    out = batch.take(idx.astype(np.int64))
    out.diffs = summed.copy()
    return out
