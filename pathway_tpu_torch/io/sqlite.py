"""SQLite connector (reference ``src/connectors/data_storage.rs``
``SqliteReader``): snapshot read of a table, optional polling for changes."""

from __future__ import annotations

import sqlite3
import time as time_mod
from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector, next_commit_time


class _SqliteConnector(BaseConnector):
    def __init__(self, node, path, table_name, schema, mode):
        super().__init__(node)
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.mode = mode
        if mode != "static":
            self.heartbeat_ms = 500

    def _snapshot(self):
        cols = list(self.node.column_names)
        conn = sqlite3.connect(self.path)
        try:
            cur = conn.execute(
                f"SELECT {', '.join(cols)} FROM {self.table_name}"  # noqa: S608
            )
            rows = {}
            pk = self.schema.primary_key_columns()
            for i, rec in enumerate(cur.fetchall()):
                values = dict(zip(cols, rec))
                key = (
                    hash_values(*[values[c] for c in pk])
                    if pk
                    else hash_values(i, *rec)
                )
                rows[key] = tuple(rec)
            return rows
        finally:
            conn.close()

    def run(self):
        prev: dict[int, tuple] = {}
        while True:
            cur = self._snapshot()
            rows = []
            for k, row in prev.items():
                if cur.get(k) != row:
                    rows.append((k, row, -1))
            for k, row in cur.items():
                if prev.get(k) != row:
                    rows.append((k, row, 1))
            prev = cur
            if rows:
                self.commit_rows(rows)
            if self.mode == "static" or self.should_stop():
                return
            time_mod.sleep(0.5)


def read(
    path: str,
    table_name: str,
    schema: Any,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    **kwargs,
) -> Table:
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"sqlite({table_name})")
    conn = _SqliteConnector(node, path, table_name, schema, mode)
    G.register_connector(conn)
    return Table(node, schema, Universe())
