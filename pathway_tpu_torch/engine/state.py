"""Materialized table state (the engine's "arrangement"), and the
sharding-aware device-state helpers (counterpart of
``pathway_tpu/engine/state.py``).

Keyed tables hold exactly one row per key (a Pathway universe). ``TableState``
applies delta batches, maintaining ``key -> row tuple`` and detecting
inconsistencies (duplicate keys, deleting missing rows) like the reference's
dataflow does via differential arrangements.

Device state (serving pools, param trees) crosses the host boundary in two
directions: gathered to the host for snapshots and checkpoints, and placed
on a mesh for a restore. The two helpers at the end are that seam, so state
moved across a topology change always means "the gathered bytes were
identical, only the placement changed".
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.parallel.mesh import ShardedTensor, place_pytree


class DuplicateKeyError(ValueError):
    pass


def values_equal(a, b) -> bool:
    """Deep value equality safe for rows containing np.ndarray (tuple ==
    on arrays raises); used by every emitted-diff comparison."""
    if a is b:
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not isinstance(a, np.ndarray) or not isinstance(b, np.ndarray):
            return False
        return a.shape == b.shape and bool(np.array_equal(a, b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(values_equal(x, y) for x, y in zip(a, b))
    try:
        return bool(a == b)
    except (ValueError, TypeError):
        return False


def rows_equal(a: tuple | None, b: tuple | None) -> bool:
    if a is None or b is None:
        return a is b
    return values_equal(a, b)


class TableState:
    __slots__ = ("column_names", "rows")

    def __init__(self, column_names: list[str]):
        self.column_names = list(column_names)
        self.rows: dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self.rows)

    def apply(self, batch: Batch) -> None:
        """Apply deltas; +1 inserts, -1 removes. Replacements arrive as
        (-1 old, +1 new) pairs within one batch — handle deletes first."""
        inserts: list[tuple[int, tuple]] = []
        for key, row, diff in batch.rows():
            if diff < 0:
                for _ in range(-diff):
                    if key not in self.rows:
                        raise DuplicateKeyError(
                            f"deletion of missing key {key} from table state"
                        )
                    del self.rows[key]
            elif diff > 0:
                for _ in range(diff):
                    inserts.append((key, row))
        for key, row in inserts:
            if key in self.rows:
                raise DuplicateKeyError(
                    f"duplicate key {key}: universe invariant violated"
                )
            self.rows[key] = row

    def get(self, key: int):
        return self.rows.get(key)

    def snapshot_batch(self) -> Batch:
        items = list(self.rows.items())
        return Batch.from_rows(
            self.column_names, [(k, row, 1) for k, row in items]
        )

    def keys_array(self) -> np.ndarray:
        return np.fromiter(self.rows.keys(), dtype=np.uint64, count=len(self.rows))


class MultisetState:
    """key -> count (for universes tracked without payload)."""

    __slots__ = ("counts",)

    def __init__(self):
        self.counts: dict[int, int] = {}

    def apply_delta(self, key: int, diff: int) -> None:
        c = self.counts.get(key, 0) + diff
        if c == 0:
            self.counts.pop(key, None)
        else:
            self.counts[key] = c

    def __contains__(self, key: int) -> bool:
        return key in self.counts


# ---- sharding-aware device state -------------------------------------------


def host_state_pytree(tree):
    """Every tensor leaf of a nested dict on the host: sharded leaves
    gathered across their shards, device leaves copied to CPU tensors.
    Other leaves pass through. The result is topology-free."""
    if isinstance(tree, dict):
        return {k: host_state_pytree(v) for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        return tree.gather().cpu()
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return tree


def place_state_pytree(tree, mesh=None, specs=None):
    """Place a host state tree onto a serving mesh with per-leaf
    ``PartitionSpec``s (replicated where unspecified); ``mesh=None``
    returns the tree untouched."""
    return place_pytree(tree, mesh, specs)
