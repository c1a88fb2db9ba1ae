"""Generic polling object-store reader with deletion tracking.

Shared engine for ``pw.io.pyfilesystem`` / ``pw.io.gdrive`` (reference: each
has its own scanner with new/changed/deleted object detection — e.g.
``io/gdrive/__init__.py:336`` scan loop, ``io/pyfilesystem``): a provider
lists objects (id → version + metadata) and fetches payloads; the connector
diffs consecutive scans into +1/-1 deltas, so downstream indexes stay in sync
when source files change or disappear.

Persistence (as JAX's): a ``persistent_id`` caches each downloaded object by
URI in the run's backend (``persistence/cached_objects.py``), and each
snapshot chunk stores the live objects' versions as the reader's offset. On
restart the live map is rebuilt from that offset and the replayed rows. The
runtime seeks the offset before ``on_replay`` (JAX: after it), so whichever
of the two hooks comes second rebuilds the map: the order does not matter.
"""

from __future__ import annotations

import time as time_mod
from typing import Any, Protocol

from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.io._streams import BaseConnector


class ObjectProvider(Protocol):
    def list_objects(self) -> dict[str, tuple[Any, dict]]:
        """object id -> (version, metadata dict)."""
        ...

    def fetch(self, object_id: str) -> bytes:
        ...


class ObjectStoreConnector(BaseConnector):
    """Polls an ObjectProvider; emits (data[, _metadata]) rows keyed by
    object id, with retractions for changed/removed objects."""

    def __init__(self, node, provider, mode: str, with_metadata: bool,
                 refresh_interval: float,
                 max_failed_attempts_in_row: int | None = 8):
        super().__init__(node)
        self.provider = provider
        self.mode = mode
        self.with_metadata = with_metadata
        self.refresh_interval = refresh_interval
        # transient remote-service failures retry this many consecutive
        # polls before the error propagates (reference sharepoint
        # ``max_failed_attempts_in_row``, xpacks/connectors/sharepoint/
        # __init__.py:185-208); None = retry forever
        self.max_failed_attempts_in_row = max_failed_attempts_in_row
        # object id -> (version, emitted row tuple)
        self._live: dict[str, tuple[Any, tuple]] = {}
        self._cache = None  # CachedObjectStorage when persistence is on
        self._replayed_rows: dict[int, tuple] = {}
        self._sought: dict | None = None
        if mode != "static":
            self.heartbeat_ms = 500

    # -- persistence (reference ``cached_object_storage.rs``: downloaded
    # objects are cached by URI so restarts replay the exact bytes the
    # crashed run saw, and replay-only runs never touch the source) --------
    def setup_persistence(self, manager) -> None:
        super().setup_persistence(manager)
        if self.persistent_id is not None:
            from pathway_tpu_torch.persistence.cached_objects import (
                CachedObjectStorage,
            )

            self._cache = CachedObjectStorage(manager.backend)

    def current_offset(self):
        """The live-object version map — with the replayed rows this fully
        reconstructs connector state on restart."""
        return {oid: version for oid, (version, _row) in self._live.items()}

    def on_replay(self, rows) -> None:
        for key, row, diff in rows:
            if diff > 0:
                self._replayed_rows[key] = row
        self._rebuild_live()

    def seek_offset(self, offset) -> None:
        if not isinstance(offset, dict):
            return
        self._sought = offset
        self._rebuild_live()

    def _rebuild_live(self) -> None:
        """``_live`` from (oid -> version) and the replayed row payloads, so
        the first scan after a restart re-emits nothing that was
        snapshotted and can still retract rows when objects change or
        disappear later. Called by both hooks; a no-op until both ran."""
        if self._sought is None or not self._replayed_rows:
            return
        for oid, version in self._sought.items():
            row = self._replayed_rows.get(hash_values(oid))
            if row is not None:
                self._live[oid] = (version, row)

    def _fetch(self, oid: str, version: Any) -> bytes:
        if self._cache is not None:
            cached = self._cache.get_version(oid, version)
            if cached is not None:
                return cached
        data = self.provider.fetch(oid)
        if self._cache is not None:
            self._cache.put(oid, version, data)
        return data

    def _scan(self) -> list[tuple[int, tuple, int]]:
        listing = self.provider.list_objects()
        deltas: list[tuple[int, tuple, int]] = []
        for oid, (version, meta) in listing.items():
            prev = self._live.get(oid)
            if prev is not None and prev[0] == version:
                continue
            try:
                data = self._fetch(oid, version)
            except Exception:
                continue  # object vanished between list and fetch
            row = (data, Json(meta)) if self.with_metadata else (data,)
            key = hash_values(oid)
            if prev is not None:
                deltas.append((key, prev[1], -1))
            deltas.append((key, row, 1))
            self._live[oid] = (version, row)
        for oid in list(self._live):
            if oid not in listing:
                version, row = self._live.pop(oid)
                deltas.append((hash_values(oid), row, -1))
                if self._cache is not None:
                    self._cache.remove(oid)
        return deltas

    def run(self) -> None:
        deltas = self._scan()  # first scan failing fails loudly
        if deltas or self._persistence is None:
            self.commit_rows(deltas)
        if self.mode == "static":
            return
        failures = 0
        while not self.should_stop():
            time_mod.sleep(self.refresh_interval)
            try:
                deltas = self._scan()
            except Exception:
                failures += 1
                if (
                    self.max_failed_attempts_in_row is not None
                    and failures >= self.max_failed_attempts_in_row
                ):
                    raise
                import logging

                logging.getLogger("pathway_tpu_torch").error(
                    "object-store scan failed (%d/%s); retrying in %ss",
                    failures, self.max_failed_attempts_in_row,
                    self.refresh_interval,
                )
                continue
            failures = 0
            if deltas:
                self.commit_rows(deltas)
