"""PostgreSQL sink (reference ``python/pathway/io/postgres``, write-only;
engine side ``PsqlWriter`` data_storage.rs:1080, ``PsqlUpdatesFormatter`` /
``PsqlSnapshotFormatter`` data_format.rs:1625,1684).

``write`` appends (time, diff)-annotated rows; ``write_snapshot`` maintains
the latest row per primary key. Works with any DB-API connection factory —
psycopg when installed, or a caller-supplied ``connection_factory`` (sqlite3
in tests).
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._utils import format_value_for_output


def _default_factory(postgres_settings: dict) -> Callable:
    def factory():
        try:
            import psycopg
        except ImportError:
            try:
                import psycopg2 as psycopg  # type: ignore[no-redef]
            except ImportError as exc:
                raise ImportError(
                    "pw.io.postgres needs psycopg/psycopg2 (or pass "
                    "connection_factory=...)"
                ) from exc
        return psycopg.connect(
            **{k: v for k, v in postgres_settings.items() if k != "connstring"}
        )

    return factory


class _SqlWriter:
    def __init__(self, factory, table_name, cols, snapshot_pk=None, max_batch_size=None):
        self.factory = factory
        self.table_name = table_name
        self.cols = cols
        self.snapshot_pk = snapshot_pk
        self.max_batch_size = max_batch_size
        self._conn = None

    def _connection(self):
        if self._conn is None:
            self._conn = self.factory()
        return self._conn

    def __call__(self, time, batch):
        conn = self._connection()
        cur = conn.cursor()
        placeholders = ", ".join(["%s"] * (len(self.cols) + 2))
        names = ", ".join(self.cols)
        if self.snapshot_pk is None:
            sql = (
                f"INSERT INTO {self.table_name} ({names}, time, diff) "
                f"VALUES ({placeholders})"
            )
            rows = [
                tuple(format_value_for_output(v) for v in row) + (time, diff)
                for _key, row, diff in batch.rows()
            ]
            try:
                cur.executemany(sql, rows)
            except Exception:
                # sqlite-style paramstyle fallback
                sql = sql.replace("%s", "?")
                cur.executemany(sql, rows)
        else:
            for _key, row, diff in batch.rows():
                vals = dict(zip(self.cols, row))
                pk_clause = " AND ".join(f"{c} = %s" for c in self.snapshot_pk)
                pk_vals = tuple(format_value_for_output(vals[c]) for c in self.snapshot_pk)
                try:
                    cur.execute(
                        f"DELETE FROM {self.table_name} WHERE {pk_clause}", pk_vals
                    )
                except Exception:
                    cur.execute(
                        f"DELETE FROM {self.table_name} WHERE {pk_clause}".replace("%s", "?"),
                        pk_vals,
                    )
                if diff > 0:
                    ph = ", ".join(["%s"] * len(self.cols))
                    ins = f"INSERT INTO {self.table_name} ({names}) VALUES ({ph})"
                    payload = tuple(format_value_for_output(vals[c]) for c in self.cols)
                    try:
                        cur.execute(ins, payload)
                    except Exception:
                        cur.execute(ins.replace("%s", "?"), payload)
        conn.commit()


def write(
    table,
    postgres_settings: dict | None = None,
    table_name: str = "",
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    connection_factory: Callable | None = None,
    **kwargs,
) -> None:
    """Append rows with time/diff columns (reference ``write``)."""
    factory = connection_factory or _default_factory(postgres_settings or {})
    cols = list(table.column_names())
    writer = _SqlWriter(factory, table_name, cols, max_batch_size=max_batch_size)
    node = SinkNode(G.engine_graph, table._node, writer, name=f"postgres({table_name})")
    G.register_sink(node)


def write_snapshot(
    table,
    postgres_settings: dict | None = None,
    table_name: str = "",
    primary_key: list[str] | None = None,
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    connection_factory: Callable | None = None,
    **kwargs,
) -> None:
    """Maintain the latest row per primary key (reference ``write_snapshot``)."""
    factory = connection_factory or _default_factory(postgres_settings or {})
    cols = list(table.column_names())
    writer = _SqlWriter(
        factory, table_name, cols, snapshot_pk=primary_key or [],
        max_batch_size=max_batch_size,
    )
    node = SinkNode(
        G.engine_graph, table._node, writer, name=f"postgres-snapshot({table_name})"
    )
    G.register_sink(node)
