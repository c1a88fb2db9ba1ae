"""Cached object storage — URI-keyed blobs for deterministic replay
(counterpart of ``pathway_tpu/persistence/cached_objects.py``).

Re-design of the reference's ``src/persistence/cached_object_storage.rs``
(377 LoC): every object an object-store connector downloads is cached in the
persistence backend keyed by URI + version, so that

* a restarted run re-reads EXACTLY the bytes the crashed run saw (the
  upstream object may have changed in between — without the cache, replay
  would be nondeterministic);
* replay-only runs (``speedrun_replay``) never touch the upstream source.

One backend key per object holds a ``{uri, version, data}`` record
(``engine.state.host_state``);
the backend's atomic put (tmp + rename for the fs backend) means a crash
mid-write loses at most that one object, which is then re-downloaded.
"""

from __future__ import annotations

import hashlib
from typing import Any

from pathway_tpu_torch.engine.state import host_state, place_state
from pathway_tpu_torch.persistence.backends import PersistenceBackend

_PREFIX = "objects"


def _uri_key(uri: str) -> str:
    return f"{_PREFIX}/{hashlib.sha1(uri.encode()).hexdigest()}"


class CachedObjectStorage:
    def __init__(self, backend: PersistenceBackend):
        self.backend = backend

    def put(self, uri: str, version: Any, data: bytes) -> None:
        self.backend.put_value(
            _uri_key(uri),
            host_state({"uri": uri, "version": version, "data": bytes(data)}),
        )

    def _load(self, uri: str) -> dict | None:
        try:
            return place_state(self.backend.get_value(_uri_key(uri)))
        except (KeyError, FileNotFoundError, OSError):
            return None

    def get(self, uri: str) -> tuple[Any, bytes] | None:
        """(version, data) or None."""
        rec = self._load(uri)
        if rec is None:
            return None
        return rec["version"], rec["data"]

    def get_version(self, uri: str, version: Any) -> bytes | None:
        """Data iff the cached version matches exactly."""
        rec = self._load(uri)
        if rec is None or rec["version"] != version:
            return None
        return rec["data"]

    def contains(self, uri: str, version: Any) -> bool:
        rec = self._load(uri)
        return rec is not None and rec["version"] == version

    def remove(self, uri: str) -> None:
        self.backend.remove_key(_uri_key(uri))

    def stored_uris(self) -> dict[str, Any]:
        """uri -> version for every cached object (used by tests/inspection;
        scans the prefix)."""
        out: dict[str, Any] = {}
        for key in self.backend.list_prefix(_PREFIX + "/"):
            try:
                rec = place_state(self.backend.get_value(key))
            except (KeyError, FileNotFoundError, OSError):
                continue
            out[rec["uri"]] = rec["version"]
        return out
