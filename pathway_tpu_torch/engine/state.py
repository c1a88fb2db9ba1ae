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

Persisted state (operator snapshots, snapshot-log chunks, worker
metadata, UDF cache values) is bytes from :func:`host_state` and comes
back through :func:`place_state`. A tensor anywhere in it is stored as a
CPU numpy array with its dtype and device (bf16 as its int16 bits) and is
revived on that device, as the row exchange sends it
(``engine/exchange.py``): a store never holds a pickled tensor storage, so
no CUDA context is tied to it. The bytes open with :data:`STORE_MAGIC`, and
the reader refuses any other package's classes: the JAX package's stores
are not read here, nor this package's by JAX.
"""

from __future__ import annotations

import io
import pickle

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


# ---- persisted state: the tensor host form ---------------------------------

STORE_MAGIC = b"pathway_tpu_torch/1\n"


class ForeignStoreError(ValueError):
    """Bytes that this package did not write (another package's store)."""


def revive_tensor(array: np.ndarray, dtype: str, device: str) -> torch.Tensor:
    """A tensor from its host form, on ``device`` (which must exist)."""
    t = torch.from_numpy(np.array(array, copy=True))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            host = obj.detach().cpu().contiguous()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            return revive_tensor, (host.numpy(), str(obj.dtype).removeprefix("torch."),
                                   str(obj.device))
        return NotImplemented


class _StoreUnpickler(pickle.Unpickler):
    # the JAX package (and JAX) by name; torch's storage rebuilders, which
    # only a pickled tensor storage would name
    _REFUSED = ("pathway_tpu", "jax", "jaxlib", "torch._utils", "torch.storage")

    def find_class(self, module, name):
        if any(module == r or module.startswith(r + ".") for r in self._REFUSED) or (
                module.startswith("torch") and "Storage" in name):
            raise pickle.UnpicklingError(f"a pathway_tpu_torch store names {module}.{name}")
        return super().find_class(module, name)


def host_state(obj) -> bytes:
    """``obj`` as store bytes, every tensor in it in its host form."""
    buf = io.BytesIO()
    buf.write(STORE_MAGIC)
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def place_state(data: bytes):
    """The object :func:`host_state` stored, its tensors back on their
    devices. Raises :class:`ForeignStoreError` on bytes without this
    package's header and ``pickle.UnpicklingError`` on any class of
    another package."""
    if not data.startswith(STORE_MAGIC):
        raise ForeignStoreError("not a pathway_tpu_torch store value")
    return _StoreUnpickler(io.BytesIO(memoryview(data)[len(STORE_MAGIC):])).load()
