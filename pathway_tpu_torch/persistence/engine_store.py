"""Engine-side persistence runtime (counterpart of
``pathway_tpu/persistence/engine_store.py``).

The analog of the reference's ``WorkerPersistentStorage``
(``src/persistence/tracker.rs``): owns the backend, per-source snapshot
writers, worker metadata, and — in operator-persisting mode — stateful
operator snapshots. Created by the graph runner when ``pw.run`` is given a
persistence config; connectors with a ``persistent_id`` are rewound
(snapshot replay + reader seek) before their threads start, and every
commit appends to the snapshot log.

``stats`` holds what a run did with its store: the bytes it wrote, the
rows it replayed and the seconds that took, and the operators it restored.
"""

from __future__ import annotations

import time as time_mod
from typing import Any

from pathway_tpu_torch.persistence.backends import (
    AzureBlobBackend,
    FilesystemBackend,
    MemoryBackend,
    MockBackend,
    PersistenceBackend,
    S3Backend,
)
from pathway_tpu_torch.persistence.snapshot import SnapshotLogReader, SnapshotLogWriter
from pathway_tpu_torch.persistence.state import MetadataAccessor


def make_backend(backend_cfg: Any) -> PersistenceBackend:
    """Instantiate an engine backend from a ``pw.persistence.Backend``."""
    if isinstance(backend_cfg, PersistenceBackend):
        return backend_cfg
    kind = getattr(backend_cfg, "kind", None)
    if kind == "filesystem":
        return FilesystemBackend(backend_cfg.path)
    if kind == "azure":
        # gated on azure-storage-blob (or an injected container_client) —
        # raises instead of silently degrading to a local path
        opts = dict(backend_cfg.options)
        account = opts.pop("account", None)
        if isinstance(account, str):
            # a plain account name/url means the real SDK path — handing a
            # string to the client slot would crash deep into the run
            opts.setdefault("account_url", account)
        elif account is not None:
            if not hasattr(account, "upload_blob"):
                raise TypeError(
                    "Backend.azure account= must be an account URL string "
                    "or a container-client-like object with upload_blob/"
                    f"download_blob, got {type(account).__name__}"
                )
            # ``account`` doubles as the injected client (stub/test usage)
            opts.setdefault("container_client", account)
        return AzureBlobBackend(container=backend_cfg.path, **opts)
    if kind == "s3":
        opts = backend_cfg.options.get("bucket_settings") or {}
        if isinstance(opts, dict):
            return S3Backend(bucket=backend_cfg.path, **opts)
        return S3Backend(bucket=backend_cfg.path, client=opts)
    if kind == "mock":
        events = backend_cfg.options.get("events")
        if isinstance(events, (MemoryBackend, MockBackend)):
            return events
        name = backend_cfg.options.get("name") or "default"
        return MemoryBackend.shared(f"mock-{name}")
    raise ValueError(f"unknown persistence backend kind: {kind!r}")


class PersistenceManager:
    def __init__(self, config: Any, worker_id: int = 0, total_workers: int = 1):
        self.config = config
        self.mode = (getattr(config, "persistence_mode", None) or "persisting").lower()
        # reference SnapshotAccess: record = write-only, replay = read-only,
        # full/None = both (crash recovery)
        self.snapshot_access = (
            getattr(config, "snapshot_access", None) or "full"
        ).lower()
        self.backend = make_backend(config.backend)
        self.metadata = MetadataAccessor(self.backend, worker_id, total_workers)
        self.worker_id = worker_id
        self.snapshot_interval_ms = getattr(config, "snapshot_interval_ms", 0) or 0
        self._writers: dict[str, SnapshotLogWriter] = {}
        self._last_finalized: int | None = None
        self._forced_input_replay = False
        self.stats = {"replayed_rows": 0, "replay_s": 0.0, "restored_operators": 0,
                      "operator_state_bytes": 0, "snapshot_bytes": 0}

    # ---------------------------------------------------------------- sources
    @property
    def do_replay(self) -> bool:
        """Whether stored snapshots are read back at startup."""
        return self.snapshot_access in ("full", "replay")

    @property
    def do_record(self) -> bool:
        """Whether new input data is appended to the snapshot log."""
        return self.snapshot_access in ("full", "record")

    @property
    def replay_inputs(self) -> bool:
        """Input-snapshot modes replay the log through the graph; operator
        persisting restores downstream state directly instead."""
        if self._forced_input_replay:
            return True
        return self.mode not in ("operator_persisting",)

    def force_input_replay(self) -> None:
        """Degrade operator-persisting to input replay for this run (some
        stateful operator had no usable snapshot)."""
        self._forced_input_replay = True

    @property
    def continue_after_replay(self) -> bool:
        explicit = getattr(self.config, "continue_after_replay", None)
        if explicit is not None:
            return explicit
        return self.mode not in ("speedrun_replay", "batch")

    def writer_for(self, persistent_id: str) -> SnapshotLogWriter:
        if persistent_id not in self._writers:
            self._writers[persistent_id] = SnapshotLogWriter(
                self.backend, persistent_id, self.worker_id
            )
        return self._writers[persistent_id]

    def rewind(self, persistent_id: str) -> tuple[list, Any]:
        """(replayed rows, stored reader offset) for a source. Chunks from a
        run that crashed before finalizing are deleted — their data is
        re-read via the returned offset, which predates them; leaving them
        would double-count once a later run raised the threshold."""
        t0 = time_mod.perf_counter()
        reader = SnapshotLogReader(self.backend, persistent_id, self.worker_id)
        rows, chunk_offset, stale = reader.replay(self.metadata.threshold_time())
        for key in stale:
            self.backend.remove_key(key)
        self.stats["replayed_rows"] += len(rows)
        self.stats["replay_s"] += time_mod.perf_counter() - t0
        # the chunk offset matches the replayed rows exactly; metadata offset
        # (written at finalize) is the fallback for logs with no stored offset
        meta_offset = self.metadata.current.offsets.get(persistent_id)
        return rows, (chunk_offset if chunk_offset is not None else meta_offset)

    def record_offset(self, persistent_id: str, offset: Any) -> None:
        if offset is not None:
            self.metadata.current.offsets[persistent_id] = offset

    # --------------------------------------------------------------- operators
    def op_state_key(self, op_sig: str) -> str:
        return f"opstate/{self.worker_id}/{op_sig}"

    def save_operator_state(self, op_sig: str, state: bytes) -> None:
        """``state``: the bytes of ``Node.state_snapshot`` (host form)."""
        self.backend.put_value(self.op_state_key(op_sig), state)
        self.stats["operator_state_bytes"] += len(state)

    def load_operator_state(self, op_sig: str) -> bytes | None:
        try:
            return self.backend.get_value(self.op_state_key(op_sig))
        except (KeyError, FileNotFoundError, OSError):
            return None

    # --------------------------------------------------------------- lifecycle
    def finalize(self, time: int, offsets: dict[str, Any] | None = None) -> None:
        """Record that this worker durably holds everything up to ``time``."""
        for w in self._writers.values():
            w.flush(time=time, offset=None)
        if offsets:
            self.metadata.current.offsets.update(
                {k: v for k, v in offsets.items() if v is not None}
            )
        self.metadata.update(finalized_time=time)
        self._last_finalized = time
        self.stats["snapshot_bytes"] = sum(w.bytes_written for w in self._writers.values())
