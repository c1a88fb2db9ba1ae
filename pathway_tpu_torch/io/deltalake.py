"""Delta Lake connector (reference ``python/pathway/io/deltalake``; engine
``DeltaTableReader``/``DeltaTableWriter`` data_storage.rs:1924,1621). Gated
on the ``deltalake`` package.

The reader FOLLOWS the table's version log as a stream (reference
``DeltaTableReader`` polls table versions and emits row-level actions,
data_storage.rs:1924-2100): each poll compares ``DeltaTable.version()``
with the last ingested version and emits +1/-1 deltas for the rows that
changed. Two mechanisms, best first:

* Change Data Feed — ``table.load_cdf(starting_version=...)`` rows carry
  ``_change_type`` (insert / delete / update_preimage / update_postimage),
  mapping directly to deltas;
* snapshot diff — reload the table at the new version and diff the full
  row multiset against the tracked live rows (works on tables without CDF
  enabled; costs a full scan per version hop).

The version number is the connector offset, so persistence restarts
resume from the next version instead of re-reading the table.
"""

from __future__ import annotations

from collections import Counter
from typing import Any

import time as time_mod

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.io._utils import format_value_for_output, parse_record_fields


def _require_deltalake():
    try:
        import deltalake  # noqa: F401

        return deltalake
    except ImportError as exc:  # pragma: no cover - gated dependency
        raise ImportError("pw.io.deltalake requires the `deltalake` package") from exc


_CDC_COLS = ("_change_type", "_commit_version", "_commit_timestamp")


class _DeltaLakeConnector(BaseConnector):
    """Version-following reader: snapshot at start, then per-version
    incremental deltas (CDF when the table provides it, multiset snapshot
    diff otherwise)."""

    def __init__(self, node, table, uri: str, schema, mode: str,
                 refresh_interval: float = 1.0):
        super().__init__(node)
        self.table = table
        self.uri = uri
        self.schema = schema
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._version = -1  # last fully ingested version
        # row tuple -> live multiplicity (content-addressed rows: delta
        # tables have no engine-visible row ids; key = hash(values, i))
        self._live: Counter = Counter()
        self._emitted_pk: dict[int, tuple] = {}
        if mode != "static":
            self.heartbeat_ms = 500

    # -- persistence: resume from the version after the snapshotted one ----
    def current_offset(self):
        return self._version

    def seek_offset(self, offset) -> None:
        if isinstance(offset, int):
            self._version = offset

    def on_replay(self, rows) -> None:
        pk = bool(self.schema.primary_key_columns())
        for key, row, diff in rows:
            if pk:
                if diff > 0:
                    self._emitted_pk[key] = row
                else:
                    self._emitted_pk.pop(key, None)
            else:
                self._live[row] += diff
                if self._live[row] <= 0:
                    del self._live[row]

    # -- row plumbing ------------------------------------------------------
    def _parse_df(self, df) -> list[tuple]:
        cols = list(self.node.column_names)
        dtypes = {n: c.dtype for n, c in self.schema.__columns__.items()}
        out = []
        for rec in df.to_dict("records"):
            values = parse_record_fields(rec, cols, dtypes, self.schema)
            out.append(tuple(values[c] for c in cols))
        return out

    def _key_of(self, row: tuple, occurrence: int, pk_idx) -> int:
        if pk_idx is not None:
            return hash_values(*[row[j] for j in pk_idx])
        return hash_values(*row, occurrence)

    def _pk_idx(self):
        pk = self.schema.primary_key_columns()
        if not pk:
            return None
        cols = list(self.node.column_names)
        return [cols.index(c) for c in pk]

    def _deltas_for_multiset(self, new_counts: Counter) -> list:
        """Move the live multiset to ``new_counts``; occurrence-indexed keys
        make repeated identical rows retract deterministically."""
        deltas = []
        for row in set(self._live) | set(new_counts):
            old_n, new_n = self._live[row], new_counts[row]
            if new_n > old_n:
                for i in range(old_n, new_n):
                    deltas.append((hash_values(*row, i), row, 1))
            elif new_n < old_n:
                for i in range(new_n, old_n):
                    deltas.append((hash_values(*row, i), row, -1))
        self._live = new_counts
        return deltas

    def _deltas_for_upsert(self, rows: list[tuple], pk_idx,
                           deletes: list[tuple] | None = None) -> list:
        deltas = []
        for row in deletes or ():
            key = self._key_of(row, 0, pk_idx)
            old = self._emitted_pk.pop(key, None)
            if old is not None:
                deltas.append((key, old, -1))
        for row in rows:
            key = self._key_of(row, 0, pk_idx)
            old = self._emitted_pk.get(key)
            if old == row:
                continue
            if old is not None:
                deltas.append((key, old, -1))
            deltas.append((key, row, 1))
            self._emitted_pk[key] = row
        return deltas

    # -- version ingestion -------------------------------------------------
    def _snapshot_deltas(self, version: int) -> list:
        """Full-table load at ``version`` diffed against tracked state."""
        if hasattr(self.table, "load_as_version"):
            try:
                self.table.load_as_version(version)
            except Exception:  # noqa: BLE001 - reader may already be there
                pass
        rows = self._parse_df(self.table.to_pandas())
        pk_idx = self._pk_idx()
        if pk_idx is not None:
            # snapshot = the complete live set: retract pks gone from it
            new_keys = {self._key_of(r, 0, pk_idx) for r in rows}
            gone = [k for k in self._emitted_pk if k not in new_keys]
            deltas = []
            for k in gone:
                deltas.append((k, self._emitted_pk.pop(k), -1))
            return deltas + self._deltas_for_upsert(rows, pk_idx)
        return self._deltas_for_multiset(Counter(rows))

    def _cdf_deltas(self, start_version: int, end_version: int) -> list | None:
        """Change-data-feed rows for (start, end]; None when CDF is not
        available on this table."""
        load_cdf = getattr(self.table, "load_cdf", None)
        if load_cdf is None:
            return None
        try:
            cdf = load_cdf(starting_version=start_version,
                           ending_version=end_version)
        except Exception:  # noqa: BLE001 - CDF not enabled on the table
            return None
        df = cdf.read_all().to_pandas() if hasattr(cdf, "read_all") else (
            cdf.to_pandas() if hasattr(cdf, "to_pandas") else cdf
        )
        if "_change_type" not in df.columns:
            return None
        adds = df[df["_change_type"].isin(["insert", "update_postimage"])]
        dels = df[df["_change_type"].isin(["delete", "update_preimage"])]
        drop = [c for c in _CDC_COLS if c in df.columns]
        add_rows = self._parse_df(adds.drop(columns=drop))
        del_rows = self._parse_df(dels.drop(columns=drop))
        pk_idx = self._pk_idx()
        if pk_idx is not None:
            return self._deltas_for_upsert(add_rows, pk_idx, deletes=del_rows)
        new_counts = Counter(self._live)
        new_counts.update(add_rows)
        new_counts.subtract(del_rows)
        new_counts = Counter({r: n for r, n in new_counts.items() if n > 0})
        return self._deltas_for_multiset(new_counts)

    def _poll(self) -> list:
        current = self.table.version()
        if current is None or current <= self._version:
            return []
        if self._version < 0:
            deltas = self._snapshot_deltas(current)
        else:
            deltas = self._cdf_deltas(self._version, current)
            if deltas is None:
                deltas = self._snapshot_deltas(current)
        self._version = current
        return deltas

    def run(self):
        deltas = self._poll()
        if deltas or self._persistence is None:
            self.commit_rows(deltas)
        if self.mode == "static":
            return
        while not self.should_stop():
            time_mod.sleep(self.refresh_interval)
            self._refresh_log()
            deltas = self._poll()
            if deltas:
                self.commit_rows(deltas)

    def _refresh_log(self) -> None:
        """See new table versions: ``update_incremental()`` when the reader
        object provides it, else RE-OPEN the table at the uri — newer
        deltalake releases drop update_incremental, and without a refresh
        ``version()`` would return the construction-time snapshot forever
        (a silently frozen source)."""
        update = getattr(self.table, "update_incremental", None)
        if update is not None:
            try:
                update()
                return
            except Exception:  # noqa: BLE001 - fall through to re-open
                pass
        try:
            import deltalake as dl

            fresh = dl.DeltaTable(self.uri)
        except Exception:  # noqa: BLE001 - injected tables / no package
            return
        if fresh.version() > self._version:
            self.table = fresh


def read(uri: str, schema: Any, *, mode: str = "streaming",
         autocommit_duration_ms: int | None = 1500,
         refresh_interval: float = 1.0,
         persistent_id: str | None = None,
         _table: Any = None, **kwargs) -> Table:
    """Read a Delta table. ``mode="streaming"`` follows the version log
    live (CDF when enabled, snapshot diff otherwise); ``mode="static"``
    ingests the current snapshot and finishes. ``_table`` injects a ready
    DeltaTable-shaped object for offline tests."""
    table = _table
    if table is None:
        dl = _require_deltalake()
        table = dl.DeltaTable(uri)
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"deltalake({uri})")
    conn = _DeltaLakeConnector(
        node, table, uri, schema, mode, refresh_interval=refresh_interval
    )
    G.register_connector(conn)
    out = Table(node, schema, Universe())
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return out


def write(table, uri: str, *, partition_columns=None,
          min_commit_frequency: int | None = 60_000, **kwargs) -> None:
    dl = _require_deltalake()
    cols = list(table.column_names())

    def write_batch(time, batch):
        import pandas as pd

        rows = []
        for _key, row, diff in batch.rows():
            doc = {c: format_value_for_output(v) for c, v in zip(cols, row)}
            doc["time"] = time
            doc["diff"] = diff
            rows.append(doc)
        if rows:
            dl.write_deltalake(uri, pd.DataFrame(rows), mode="append",
                               partition_by=partition_columns)

    node = SinkNode(G.engine_graph, table._node, write_batch, name=f"deltalake({uri})")
    G.register_sink(node)
