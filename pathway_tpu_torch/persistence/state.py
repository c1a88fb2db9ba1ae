"""Worker metadata & global finalized-frontier consensus (counterpart of
``pathway_tpu/persistence/state.py``).

Re-design of the reference's ``src/persistence/state.rs``: each worker
periodically stores a ``StoredMetadata`` blob (finalized time, reader
offsets, operator-state chunk refs). The global *threshold time* — the time
up to which ALL workers have finalized — is the min of the per-worker
finalized times; snapshot replay is truncated at the threshold so no worker
replays data another worker never durably logged.
"""

from __future__ import annotations

import time as time_mod
from typing import Any

from pathway_tpu_torch.engine.state import host_state, place_state
from pathway_tpu_torch.persistence.backends import PersistenceBackend

_FORMAT_VERSION = 1


def _meta_key(worker_id: int) -> str:
    return f"metadata/worker-{worker_id}"


class StoredMetadata:
    def __init__(
        self,
        worker_id: int = 0,
        finalized_time: int | None = None,
        offsets: dict[str, Any] | None = None,
        operator_state_keys: dict[str, str] | None = None,
        wall_time: float | None = None,
    ):
        self.version = _FORMAT_VERSION
        self.worker_id = worker_id
        self.finalized_time = finalized_time
        self.offsets = offsets or {}
        self.operator_state_keys = operator_state_keys or {}
        self.wall_time = wall_time if wall_time is not None else time_mod.time()


class MetadataAccessor:
    def __init__(self, backend: PersistenceBackend, worker_id: int = 0, total_workers: int = 1):
        self.backend = backend
        self.worker_id = worker_id
        self.total_workers = total_workers
        self.current = self._load(worker_id) or StoredMetadata(worker_id)

    def _load(self, worker_id: int) -> StoredMetadata | None:
        try:
            data = self.backend.get_value(_meta_key(worker_id))
        except (KeyError, FileNotFoundError, OSError):
            return None
        # bytes of another package's store raise here (ForeignStoreError)
        return place_state(data)

    def save(self) -> None:
        self.current.wall_time = time_mod.time()
        self.backend.put_value(_meta_key(self.worker_id), host_state(self.current))

    def update(
        self,
        finalized_time: int | None = None,
        offsets: dict[str, Any] | None = None,
        operator_state_keys: dict[str, str] | None = None,
    ) -> None:
        if finalized_time is not None:
            self.current.finalized_time = finalized_time
        if offsets is not None:
            self.current.offsets.update(offsets)
        if operator_state_keys is not None:
            self.current.operator_state_keys.update(operator_state_keys)
        self.save()

    def threshold_time(self) -> int | None:
        """Min finalized time across all workers that have stored metadata
        (reference ``state.rs:135-155``); None = no worker finalized yet."""
        times: list[int] = []
        for w in range(self.total_workers):
            meta = self.current if w == self.worker_id else self._load(w)
            if meta is None or meta.finalized_time is None:
                return None
            times.append(meta.finalized_time)
        return min(times) if times else None
