"""``pw.persistence`` — checkpoint/resume configuration (counterpart of
``pathway_tpu/persistence/__init__.py``).

Parity with reference ``python/pathway/persistence/__init__.py`` (Backend
filesystem/s3/azure/mock, Config with snapshot_interval_ms and
persistence_mode). The engine-side snapshotting (input snapshot log, replay,
metadata frontier) lives in :mod:`pathway_tpu_torch.persistence.engine_store`.

A ``Config`` reaches a run as ``pw.run(persistence_config=...)``: the port
reads no ``PATHWAY_REPLAY_STORAGE`` / ``PATHWAY_SNAPSHOT_ACCESS`` /
``PATHWAY_PERSISTENCE_MODE`` / ``PATHWAY_CONTINUE_AFTER_REPLAY`` variable;
the CLI's ``replay`` builds the ``Config`` those variables describe and
hands it to the program's runs (``cli.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any


class Backend:
    def __init__(self, kind: str, path: str | None = None, **kwargs):
        self.kind = kind
        self.path = path
        self.options = kwargs

    @classmethod
    def filesystem(cls, path: str | os.PathLike) -> "Backend":
        return cls("filesystem", os.fspath(path))

    @classmethod
    def s3(cls, root_path: str, bucket_settings: Any = None) -> "Backend":
        return cls("s3", root_path, bucket_settings=bucket_settings)

    @classmethod
    def azure(cls, root_path: str, account: Any = None, **kw) -> "Backend":
        return cls("azure", root_path, account=account, **kw)

    @classmethod
    def mock(cls, events: Any = None) -> "Backend":
        return cls("mock", None, events=events)


@dataclass
class Config:
    backend: Backend | None = None
    snapshot_interval_ms: int = 0
    persistence_mode: str = "persisting"
    snapshot_access: str | None = None
    continue_after_replay: bool | None = None  # None = mode-based default

    @classmethod
    def simple_config(cls, backend: Backend, **kwargs) -> "Config":
        return cls(backend=backend, **kwargs)


_persistent_sources: dict[str, Any] = {}


def register_persistent_source(persistent_id: str, connector: Any) -> None:
    _persistent_sources[persistent_id] = connector
    connector.persistent_id = persistent_id


def get_persistent_sources() -> dict[str, Any]:
    return dict(_persistent_sources)


from pathway_tpu_torch.persistence.backends import (  # noqa: E402
    AzureBlobBackend,
    FilesystemBackend,
    MemoryBackend,
    MockBackend,
    PersistenceBackend,
    S3Backend,
)
from pathway_tpu_torch.persistence.engine_store import PersistenceManager  # noqa: E402
from pathway_tpu_torch.persistence.snapshot import (  # noqa: E402
    SnapshotLogReader,
    SnapshotLogWriter,
)
from pathway_tpu_torch.persistence.state import MetadataAccessor, StoredMetadata  # noqa: E402

__all__ = [
    "AzureBlobBackend",
    "Backend",
    "Config",
    "FilesystemBackend",
    "MemoryBackend",
    "MetadataAccessor",
    "MockBackend",
    "PersistenceBackend",
    "PersistenceManager",
    "S3Backend",
    "SnapshotLogReader",
    "SnapshotLogWriter",
    "StoredMetadata",
    "register_persistent_source",
    "get_persistent_sources",
]


from contextlib import contextmanager


@contextmanager
def get_persistence_engine_config(persistence_config):
    """Yield the engine-level persistence config for a run (reference
    ``persistence/__init__.py:165``); None passes through."""
    if persistence_config is None:
        yield None
        return
    yield persistence_config
