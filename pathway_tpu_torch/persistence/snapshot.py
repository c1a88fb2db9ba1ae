"""Input snapshot streams — replay-then-resume event logs (counterpart of
``pathway_tpu/persistence/snapshot.py``).

Re-design of the reference's ``src/persistence/input_snapshot.rs``: per
(persistent_id, worker) append-only log of ``SnapshotEvent``s
(Insert/Delete/AdvanceTime) plus the reader offset in effect when each chunk
was flushed. On restart the log is replayed (consolidated by key) and the
connector's reader is sought past the stored offset, giving
exactly-once-style resumption without re-reading the source.

Chunks are individually stored blobs (``engine.state.host_state``: a
tensor cell in its host form) named with a monotonically increasing
sequence number; a chunk is only visible after an atomic backend put, so a
crash mid-flush loses at most the unflushed tail (which the seek offset
then re-reads).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.engine.state import host_state, place_state
from pathway_tpu_torch.persistence.backends import PersistenceBackend

_FORMAT_VERSION = 1


def _chunk_key(persistent_id: str, worker_id: int, seq: int) -> str:
    return f"streams/{persistent_id}/{worker_id}/{seq:010d}"


class SnapshotLogWriter:
    """Buffers row events; each ``advance`` (commit) flushes a chunk with the
    connector's current offset."""

    def __init__(
        self,
        backend: PersistenceBackend,
        persistent_id: str,
        worker_id: int = 0,
        flush_every_rows: int = 100_000,
    ):
        from pathway_tpu_torch.engine import chaos

        self.backend = backend
        self.persistent_id = persistent_id
        self.worker_id = worker_id
        self.flush_every_rows = flush_every_rows
        self._chaos_put = chaos.site("persist.put")
        existing = backend.list_prefix(f"streams/{persistent_id}/{worker_id}/")
        self._seq = (
            max(int(k.rsplit("/", 1)[1]) for k in existing) + 1 if existing else 0
        )
        self._rows: list[tuple[Any, tuple, int]] = []
        self.bytes_written = 0

    def write_rows(self, rows: list[tuple[Any, tuple, int]]) -> None:
        """rows: (key, value-tuple, diff)."""
        self._rows.extend(rows)
        if len(self._rows) >= self.flush_every_rows:
            self.flush(time=None, offset=None)

    def advance(self, time: int, offset: Any = None) -> None:
        self.flush(time=time, offset=offset)

    def flush(self, time: int | None, offset: Any) -> None:
        if not self._rows and offset is None:
            return
        chunk = {
            "version": _FORMAT_VERSION,
            "rows": self._rows,
            "time": time,
            "offset": offset,
        }
        if self._chaos_put is not None:
            # raise BEFORE the put: the buffered rows stay queued for the
            # next flush, matching a real backend write failure
            self._chaos_put.maybe_fail()
        blob = host_state(chunk)
        self.backend.put_value(
            _chunk_key(self.persistent_id, self.worker_id, self._seq), blob)
        self.bytes_written += len(blob)
        self._seq += 1
        self._rows = []


class SnapshotLogReader:
    def __init__(self, backend: PersistenceBackend, persistent_id: str, worker_id: int = 0):
        self.backend = backend
        self.persistent_id = persistent_id
        self.worker_id = worker_id

    def replay(
        self, threshold_time: int | None = None
    ) -> tuple[list[tuple[Any, tuple, int]], Any, list[str]]:
        """Return (consolidated rows, last stored reader offset, stale keys).

        Rows are consolidated by (key, value) so replay emits the net state:
        inserts minus deletions, with multiplicities (reference replays the
        raw event log into an input session, which consolidates identically).

        A chunk counts as finalized only if it — or a LATER chunk in the same
        log — carries a commit time ``<= threshold_time``: untimed overflow
        chunks (flushed mid-commit by ``write_rows``) are committed by the
        next timed chunk. Everything past the cut — chunks from a run that
        crashed before finalizing — is returned in ``stale`` so the caller
        can delete it; its data is re-read via the stored reader offset,
        which predates it.
        """
        counts: dict[tuple[Any, Any], int] = {}
        first: dict[tuple[Any, Any], tuple] = {}
        order: list[tuple[Any, Any]] = []
        offset: Any = None
        pending: list[tuple[str, dict]] = []  # untimed chunks awaiting a timed commit
        stale: list[str] = []

        def consume(chunk: dict) -> None:
            nonlocal offset
            ids = row_identities([row for _k, row, _d in chunk["rows"]])
            for (k, row, diff), rid in zip(chunk["rows"], ids):
                ck = (k, rid)
                if ck not in counts:
                    counts[ck] = 0
                    first[ck] = row
                    order.append(ck)
                counts[ck] += diff
            if chunk.get("offset") is not None:
                offset = chunk["offset"]

        cut = False
        for key in self.backend.list_prefix(
            f"streams/{self.persistent_id}/{self.worker_id}/"
        ):
            if cut:
                stale.append(key)
                continue
            try:
                chunk = place_state(self.backend.get_value(key))
                t = chunk.get("time")
            except Exception as exc:  # noqa: BLE001 - torn trailing chunk
                # a crash mid-put can leave a truncated/corrupt chunk as
                # the log's tail; its rows are re-read via the stored
                # reader offset (which predates it), so cut HERE — keep
                # everything already consolidated, mark the rest stale
                from pathway_tpu_torch.internals.errors import get_global_error_log

                get_global_error_log().log(
                    f"snapshot replay: skipping torn chunk {key} "
                    f"({type(exc).__name__}: {exc})"
                )
                cut = True
                stale.extend(k for k, _ in pending)
                pending = []
                stale.append(key)
                continue
            if t is None:
                pending.append((key, chunk))
                continue
            if threshold_time is not None and t > threshold_time:
                cut = True
                stale.extend(k for k, _ in pending)
                pending = []
                stale.append(key)
                continue
            for _, p in pending:
                consume(p)
            pending = []
            consume(chunk)
        # untimed tail with no committing timed chunk: not finalized
        stale.extend(k for k, _ in pending)
        rows = [
            (ck[0], first[ck], diff) for ck in order if (diff := counts[ck]) != 0
        ]
        return rows, offset, stale

    def truncate(self) -> None:
        for key in self.backend.list_prefix(
            f"streams/{self.persistent_id}/{self.worker_id}/"
        ):
            self.backend.remove_key(key)


def _has_array(row: tuple) -> bool:
    return any(isinstance(v, (np.ndarray, torch.Tensor, list)) for v in row)


def row_identities(rows: list[tuple]) -> list:
    """A hashable identity of each row's values. JAX consolidates by the
    row tuple itself; a row with a tensor or array cell, which does not
    hash by value, is identified here by each such cell's dtype, shape and
    bytes. The CUDA tensor cells of all ``rows`` (each object once) are
    flattened, joined a device and copied to the host at once: one
    device-to-host transfer a device a call, not one a cell."""
    if not any(_has_array(r) for r in rows):
        return rows
    on_card: dict[torch.device, dict[int, torch.Tensor]] = {}
    for row in rows:
        for v in row:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                on_card.setdefault(v.device, {})[id(v)] = v
    blobs: dict[int, bytes] = {}
    for by_id in on_card.values():
        tensors = list(by_id.values())
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
        host = torch.cat(flat).cpu().numpy().tobytes()
        at = 0
        for t, f in zip(tensors, flat):
            blobs[id(t)] = host[at : at + f.numel()]
            at += f.numel()

    def cell(v):
        if id(v) in blobs and isinstance(v, torch.Tensor):
            return ("t", str(v.dtype), tuple(v.shape), blobs[id(v)])
        return _cell_key(v)

    return [tuple(cell(v) for v in r) if _has_array(r) else r for r in rows]


def _cell_key(v):
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous().reshape(-1)
        return ("t", str(v.dtype), tuple(v.shape), t.view(torch.uint8).numpy().tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_cell_key(x) for x in v)
    return v
