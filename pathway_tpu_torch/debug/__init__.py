"""``pw.debug`` — table literals, compute-and-print, pandas interop.

Parity with reference ``python/pathway/debug/__init__.py``:
``table_from_markdown``, ``table_from_pandas``, ``table_from_rows``,
``compute_and_print``, ``compute_and_print_update_stream``,
``table_to_pandas``, ``table_to_dicts``, ``StreamGenerator``. The pandas
helpers import pandas where they run; nothing else here needs it.
"""

from __future__ import annotations

import re
from typing import Any, Iterable

import numpy as np

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.value import ERROR, Pointer, hash_values
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.run import capture_table
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe

__all__ = [
    "table_from_csv",
    "table_from_markdown",
    "table_from_pandas",
    "table_from_parquet",
    "table_from_rows",
    "table_to_csv",
    "table_to_pandas",
    "table_to_parquet",
    "compute_and_print",
    "compute_and_print_update_stream",
    "table_to_dicts",
    "StreamGenerator",
]


def _parse_value(raw: str):
    raw = raw.strip()
    if raw in ("", "None"):
        return None
    if raw == "True":
        return True
    if raw == "False":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
        return raw[1:-1]
    return raw


def table_from_markdown(
    table_def: str,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Any | None = None,
    _stream: bool = False,
) -> Table:
    """Build a static table from a markdown/ascii table literal."""
    lines = [
        ln.strip()
        for ln in table_def.strip().splitlines()
        if ln.strip() and not set(ln.strip()) <= {"-", "|", "+", " ", "="}
    ]
    header = [h.strip() for h in lines[0].split("|")]
    if header and header[-1] == "" and not lines[0].rstrip().endswith("| "):
        # allow trailing pipe style; empty LEADING header cell means id column
        pass
    while len(header) > 1 and header[-1] == "" and all(
        ln.rstrip().endswith("|") for ln in lines
    ):
        header = header[:-1]
    rows_raw = []
    for ln in lines[1:]:
        cells = [c.strip() for c in ln.split("|")]
        # pad/truncate to header length
        cells += [""] * (len(header) - len(cells))
        rows_raw.append(cells[: len(header)])
    has_id = header and header[0] in ("", "id")
    special = {"__time__", "__diff__"}
    value_cols = [
        h for h in (header[1:] if has_id else header) if h not in special
    ]
    parsed_rows = []
    for cells in rows_raw:
        record = dict(zip(header, cells))
        values = {c: _parse_value(record[c]) for c in value_cols}
        rid = record.get(header[0]) if has_id else None
        time = int(record["__time__"]) if "__time__" in record else 0
        diff = int(record["__diff__"]) if "__diff__" in record else 1
        parsed_rows.append((rid, values, time, diff))
    # schema inference
    if schema is not None:
        sch = schema
        col_dtypes = {n: c.dtype for n, c in sch.__columns__.items()}
        value_cols = [c for c in value_cols if c in sch.__columns__]
    else:
        col_dtypes = {}
        for c in value_cols:
            vals = [r[1][c] for r in parsed_rows if r[1][c] is not None]
            col_dtypes[c] = (
                dt.lub(*[dt.dtype_of_value(v) for v in vals]) if vals else dt.ANY
            )
        defs = {
            c: schema_mod.ColumnDefinition(dtype=col_dtypes[c], name=c)
            for c in value_cols
        }
        sch = schema_mod.schema_builder_from_definitions(defs)
    id_from = id_from or sch.primary_key_columns()
    if (
        id_from is None
        and not has_id
        and any(diff != 1 for _r, _v, _t, diff in parsed_rows)
    ):
        # update-stream literal: key by row content so retractions match
        id_from = value_cols

    rows: list[tuple[int, tuple, int, int]] = []  # (key, row, time, diff)
    for i, (rid, values, time, diff) in enumerate(parsed_rows):
        coerced = tuple(
            dt.coerce_value(values[c], col_dtypes[c]) for c in value_cols
        )
        if id_from is not None:
            key = hash_values(*[values[c] for c in id_from])
        elif rid is not None and str(rid) != "":
            key = (
                int(rid) if unsafe_trusted_ids and str(rid).isdigit() else hash_values(str(rid))
            )
        else:
            key = hash_values(i)
        rows.append((key, coerced, time, diff))
    return _static_table_from_keyed_rows(value_cols, sch, rows, stream=_stream)


parse_to_table = table_from_markdown


def _static_table_from_keyed_rows(
    value_cols: list[str],
    sch,
    rows: list[tuple[int, tuple, int, int]],
    stream: bool = False,
) -> Table:
    node = InputNode(G.engine_graph, value_cols, name="StaticTable")
    if stream or any(t != 0 for _k, _r, t, _d in rows):
        from pathway_tpu_torch.io._streams import StaticStreamConnector

        conn = StaticStreamConnector(node, rows, value_cols)
        G.register_connector(conn)
    else:
        batch = Batch.from_rows(value_cols, [(k, r, d) for k, r, _t, d in rows])
        G.register_static_source(node, lambda b=batch: b)
    return Table(node, sch, Universe())


def table_from_rows(
    schema: Any,
    rows: list[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    cols = list(schema.column_names())
    pk = schema.primary_key_columns()
    out = []
    seen: dict = {}
    for row in rows:
        if is_stream:
            *vals, time, diff = row
        else:
            vals, time, diff = list(row), 0, 1
        values = dict(zip(cols, vals))
        if pk:
            key = hash_values(*[values[c] for c in pk])
        else:
            key = hash_values(*vals)
            if not is_stream:
                # duplicate static rows are distinct rows: salt repeats with
                # their occurrence index (first occurrence keeps the plain
                # content hash for backward-compatible keys)
                n = seen.get(key, 0)
                seen[key] = n + 1
                if n:
                    key = hash_values(*vals, n)
        out.append((key, tuple(vals), time, diff))
    return _static_table_from_keyed_rows(cols, schema, out, stream=is_stream)


def table_from_pandas(
    df: pd.DataFrame,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: Any | None = None,
) -> Table:
    import pandas as pd

    if schema is None:
        schema = schema_mod.schema_from_pandas(df, id_from=id_from)
    cols = [c for c in schema.column_names()]
    rows = []
    pk = id_from or schema.primary_key_columns()
    dtypes = {n: c.dtype for n, c in schema.__columns__.items()}
    for i, (idx, row) in enumerate(df.iterrows()):
        values = {}
        for c in cols:
            v = row[c]
            if isinstance(v, float) and pd.isna(v):
                v = None
            elif v is pd.NaT:
                v = None
            elif isinstance(v, np.integer):
                v = int(v)
            elif isinstance(v, np.floating):
                v = float(v)
            elif isinstance(v, np.bool_):
                v = bool(v)
            values[c] = dt.coerce_value(v, dtypes[c])
        if pk:
            key = hash_values(*[values[c] for c in pk])
        else:
            key = hash_values(idx if not isinstance(idx, int) else i)
        rows.append((key, tuple(values[c] for c in cols), 0, 1))
    return _static_table_from_keyed_rows(cols, schema, rows)


def table_from_csv(path: str, **kwargs) -> Table:
    """A static table of a CSV file (read by pandas), as
    :func:`table_from_pandas` makes it; ``kwargs`` go to it."""
    import pandas as pd

    return table_from_pandas(pd.read_csv(path), **kwargs)


def table_from_parquet(path: str, **kwargs) -> Table:
    """A static table of a parquet file (read by pandas through pyarrow)."""
    import pandas as pd

    return table_from_pandas(pd.read_parquet(path), **kwargs)


def _format_value(v) -> str:
    if v is None:
        return "None"
    if v is ERROR:
        return "Error"
    if isinstance(v, str):
        return v
    return repr(v) if isinstance(v, (bytes,)) else str(v)


def table_to_pandas(table: Table, *, include_id: bool = True) -> "pd.DataFrame":
    import pandas as pd

    cap = capture_table(table)
    cols = cap.column_names
    keys = []
    data: dict[str, list] = {c: [] for c in cols}
    for k, row in sorted(cap.state.rows.items()):
        keys.append(Pointer(k))
        for c, v in zip(cols, row):
            data[c].append(v)
    df = pd.DataFrame(data, columns=cols)
    if include_id:
        df.index = pd.Index(keys, name="id")
    return df


def table_to_csv(table: Table, path: str, **kwargs) -> None:
    """The table's rows, without ids, in key order, to a CSV file;
    ``kwargs`` go to ``DataFrame.to_csv``."""
    table_to_pandas(table, include_id=False).to_csv(path, index=False, **kwargs)


def table_to_parquet(table: Table, path: str, **kwargs) -> None:
    """The table's rows, without ids, in key order, to a parquet file
    (``kwargs`` are accepted and not used, as in JAX)."""
    table_to_pandas(table, include_id=False).to_parquet(path, index=False)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    squash_updates: bool = True,
) -> None:
    cap = capture_table(table)
    cols = cap.column_names
    items = sorted(
        cap.state.rows.items(), key=lambda kv: tuple(map(_sort_key, kv[1]))
    )
    if n_rows is not None:
        items = items[:n_rows]
    header = (["id"] if include_id else []) + ["|"] + cols if include_id else cols
    out_rows = []
    for k, row in items:
        cells = ([repr(Pointer(k))] if include_id else []) + (
            ["|"] if include_id else []
        ) + [_format_value(v) for v in row]
        out_rows.append(cells)
    widths = [
        max([len(h) for h in [str(x)]] + [len(r[i]) for r in out_rows])
        for i, x in enumerate(header)
    ] if out_rows else [len(str(h)) for h in header]
    print(" ".join(str(h).ljust(w) for h, w in zip(header, widths)).rstrip())
    for r in out_rows:
        print(" ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


def _sort_key(v):
    if v is None:
        return (0, "")
    if v is ERROR:
        return (3, "")
    try:
        return (1, float(v))
    except (TypeError, ValueError):
        return (2, str(v))


def compute_and_print_update_stream(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
) -> None:
    cap = capture_table(table)
    cols = list(cap.column_names)
    print("\t".join((["id"] if include_id else []) + cols + ["__time__", "__diff__"]))
    count = 0
    for time, batch in cap.updates:
        for k, row, diff in batch.rows():
            if n_rows is not None and count >= n_rows:
                return
            cells = ([repr(Pointer(k))] if include_id else []) + [
                _format_value(v) for v in row
            ] + [str(time), str(diff)]
            print("\t".join(cells))
            count += 1


def table_to_dicts(table: Table, **kwargs):
    """Return ``(keys, {column: {key: value}})`` for a computed table
    (reference ``debug/__init__.py:61``)."""
    cap = capture_table(table)
    keys = list(cap.state.rows.keys())
    names = list(cap.column_names)
    columns = {
        name: {key: cap.state.rows[key][i] for key in keys}
        for i, name in enumerate(names)
    }
    return keys, columns


class StreamGenerator:
    """Builds artificial streaming tables batch by batch (reference
    ``debug/__init__.py:496``).  Single-process: worker ids are accepted for
    API parity and ignored; batches become consecutive engine epochs."""

    def table_from_list_of_batches(self, batches, schema):
        """Each batch is a list of ``{column: value}`` rows; batch ``i``
        arrives at engine time ``2*(i+1)``."""
        cols = list(schema.column_names())
        rows = []
        for i, batch in enumerate(batches):
            t = 2 * (i + 1)
            for values in batch:
                rows.append(tuple(values[c] for c in cols) + (t, 1))
        return table_from_rows(schema, rows, is_stream=True)

    def table_from_list_of_batches_by_workers(self, batches, schema):
        """Each batch maps worker id → rows; workers are collapsed."""
        flat = [
            [values for rows in batch.values() for values in rows]
            for batch in batches
        ]
        return self.table_from_list_of_batches(flat, schema)

    def table_from_pandas(self, df, id_from=None, unsafe_trusted_ids=False,
                          schema=None):
        """Honors ``_time`` / ``_diff`` columns (``_worker`` ignored)."""
        df = df.copy()
        if "_time" not in df:
            df["_time"] = 2
        if "_diff" not in df:
            df["_diff"] = 1
        value_cols = [c for c in df.columns if c not in ("_time", "_diff", "_worker")]
        if schema is None:
            from pathway_tpu_torch.internals.schema import schema_from_types

            schema = schema_from_types(
                **{c: _dtype_from_pandas(df[c]) for c in value_cols}
            )
        # per-column extraction: iterrows() would upcast mixed-dtype rows
        # (int columns silently becoming float64)
        col_values = {c: df[c].tolist() for c in value_cols}
        times = df["_time"].tolist()
        diffs = df["_diff"].tolist()
        rows = [
            tuple(col_values[c][i] for c in value_cols)
            + (int(times[i]), int(diffs[i]))
            for i in range(len(df))
        ]
        return table_from_rows(schema, rows, is_stream=True)


def _dtype_from_pandas(series) -> type:
    import pandas as pd

    if pd.api.types.is_integer_dtype(series):
        return int
    if pd.api.types.is_float_dtype(series):
        return float
    if pd.api.types.is_bool_dtype(series):
        return bool
    return str
