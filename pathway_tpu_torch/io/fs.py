"""Filesystem connector — CSV / jsonlines / plaintext / binary over files and
directories, static or streaming (directory watching).

Reference parity: ``python/pathway/io/fs`` + ``src/connectors/posix_like.rs``
(scanner × tokenizer), ``ConnectorMode::{Static,Streaming}``, ``with_metadata``.
CSV without metadata and primary keys parses in the C++ engine loops
(``csv_cols``), JSON lines too; a failed build raises. In streaming mode a
file that disappears retracts the rows it gave, and a file that changes
retracts its old rows before its new ones are read, as the reference's
scanner does. With ``EngineConfig(processes=N)`` each process reads a
share: a keyless source whole files, by the hash of their path; a
primary-keyed (upsert) source the rows whose key it owns, out of every
file, so that one process holds every version of a key. ``write`` then
writes one file a process, ``filename.{process_id}``, opened when the run
starts.
"""

from __future__ import annotations

import csv as csv_mod
import glob as glob_mod
import json
import os
import time as time_mod
from typing import Any

import numpy as np

from pathway_tpu_torch.engine.batch import Batch, concat_batches
from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.engine.value import hash_values, keys_for_value_columns, shard_of_key
from pathway_tpu_torch.internals import config as config_mod
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.io._utils import (
    CsvParserSettings,
    cols_from_bytes,
    fast_cols_eligible,
    fast_rows_eligible,
    format_value_for_output,
    iter_records_from_bytes,
    rows_from_bytes,
)


def _list_files(path: str) -> list[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return sorted(out)
    matches = sorted(glob_mod.glob(path))
    if matches:
        return matches
    if os.path.exists(path):
        return [path]
    return []


def _metadata_for(path: str) -> Json:
    try:
        st = os.stat(path)
        return Json(
            {
                "path": os.path.abspath(path),
                "size": st.st_size,
                "modified_at": int(st.st_mtime),
                "seen_at": int(time_mod.time()),
                "owner": str(st.st_uid),
            }
        )
    except OSError:
        return Json({"path": path})


def _iter_records(path: str, fmt: str, schema, csv_settings: CsvParserSettings | None):
    """Yield per-file value dicts via the shared byte parser
    (``iter_records_from_bytes``). The connector materializes each file's
    rows anyway, so slurping costs no extra memory. Absent fields take the
    schema column's default_value; explicit nulls stay None."""
    with open(path, "rb") as f:
        data = f.read()
    yield from iter_records_from_bytes(data, fmt, schema, csv_settings)


def _object_col(values) -> np.ndarray:
    # one cell at a time, NOT np.array(list) or a slice assignment:
    # equal-length list/tuple values would broadcast as a 2-D array
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


class _FsConnector(BaseConnector):
    def __init__(
        self,
        node,
        path: str,
        fmt: str,
        schema,
        mode: str,
        with_metadata: bool,
        csv_settings,
        refresh_interval: float = 0.5,
    ):
        super().__init__(node)
        self.path = path
        self.fmt = fmt
        self.schema = schema
        self.mode = mode
        self.with_metadata = with_metadata
        self.csv_settings = csv_settings
        self.refresh_interval = refresh_interval
        self._seen: dict[str, float] = {}
        # primary-keyed sources are upsert sessions (reference
        # SessionType::Upsert): later rows with an existing key retract the
        # previous row instead of duplicating the key
        self._emitted_pk: dict[int, tuple] = {}
        # what each file gave, kept while streaming so that a file that
        # goes away or changes can be retracted: keyless sources keep the
        # file's +1 batch, upsert sources the keys whose row it last set
        self._track = mode != "static"
        self._file_batch: dict[str, Batch] = {}
        self._file_keys: dict[str, list[int]] = {}
        self._pk_src: dict[int, str] = {}
        if mode != "static":
            self.heartbeat_ms = 500

    shardable = True  # files partition across processes by path hash

    def _owned(self) -> "tuple[int, int] | None":
        """(processes, process_id) of the run when it has several, else None."""
        cfg = config_mod.active()
        return (cfg.processes, cfg.process_id) if cfg.processes > 1 else None

    def _retract_file(self, fp: str) -> list[Batch]:
        """The retraction of everything ``fp`` gave, as batches."""
        old = self._file_batch.pop(fp, None)
        out = [] if old is None else [old.negate()]
        rows = []
        for key in self._file_keys.pop(fp, ()):
            if self._pk_src.get(key) == fp:
                del self._pk_src[key]
                rows.append((key, self._emitted_pk.pop(key), -1))
        if rows:
            out.append(Batch.from_rows(self.node.column_names, rows))
        return out

    def _changed_files(self, seen: dict[str, float]) -> tuple[list[tuple[str, float]], list[Batch]]:
        """The files to read this poll (new or modified, listing order)
        and the retractions of those that went away or changed."""
        listed = _list_files(self.path)
        owned = self._owned()
        if owned is not None and not self.schema.primary_key_columns():
            # keyless sources shard whole files by path; primary-keyed
            # (upsert) sources shard by KEY (every process scans every
            # file and keeps its key shard, in _read_all)
            n_proc, pid = owned
            listed = [fp for fp in listed if shard_of_key(hash_values(fp), n_proc) == pid]
        retract: list[Batch] = []
        if self._track:
            present = set(listed)
            for fp in [f for f in seen if f not in present]:
                del seen[fp]
                retract.extend(self._retract_file(fp))
        todo = []
        for fp in listed:
            try:
                mtime = os.path.getmtime(fp)
            except OSError:
                continue
            if fp in seen and seen[fp] >= mtime:
                continue
            if fp in seen and self._track:
                retract.extend(self._retract_file(fp))
            todo.append((fp, mtime))
        return todo, retract

    def _read_all(self, seen: dict[str, float]) -> Batch | None:
        cols = list(self.node.column_names)
        pk = self.schema.primary_key_columns()
        todo, retract = self._changed_files(seen)
        if (
            not pk
            and not self.with_metadata
            and fast_cols_eligible(self.fmt, self.csv_settings)
        ):
            return concat_batches(retract + self._read_fast_batch(seen, todo, cols))
        # collect rows + key sources, then hash keys in ONE columnar native
        # pass — per-row hash_values dominated wordcount-class profiles
        entries: list[tuple[tuple, tuple]] = []  # (row, key source values)
        owners: list[str] = []
        for fp, mtime in todo:
            if not self.with_metadata and fast_rows_eligible(self.fmt):
                # C++ batch parse: bytes -> row tuples in one pass; `seen`
                # advances only after a successful read — a transient
                # OSError retries next poll instead of dropping the file
                try:
                    with open(fp, "rb") as f:
                        data = f.read()
                except OSError:
                    continue
                seen[fp] = mtime
                fast = rows_from_bytes(data, self.fmt, self.schema)
                if pk:
                    pk_idx = [cols.index(c) for c in pk]
                    entries.extend((r, tuple(r[j] for j in pk_idx)) for r in fast)
                else:
                    entries.extend((r, (fp, i)) for i, r in enumerate(fast))
                owners.extend([fp] * len(fast))
                continue
            seen[fp] = mtime
            meta = _metadata_for(fp) if self.with_metadata else None
            for i, values in enumerate(
                _iter_records(fp, self.fmt, self.schema, self.csv_settings)
            ):
                if self.with_metadata:
                    values = {**values, "_metadata": meta}
                entries.append((tuple(values[c] for c in cols),
                                tuple(values[c] for c in pk) if pk else (fp, i)))
                owners.append(fp)
        if not entries:
            return concat_batches(retract)
        n = len(entries)
        keys = keys_for_value_columns(
            [_object_col([e[1][j] for e in entries]) for j in range(len(entries[0][1]))], n)
        rows: list[tuple[int, tuple, int]] = []
        if pk:
            owned = self._owned()
            for (row, _src), key_np, fp in zip(entries, keys, owners):
                key = int(key_np)
                if owned is not None and shard_of_key(key, owned[0]) != owned[1]:
                    continue
                if self._track:
                    self._file_keys.setdefault(fp, []).append(key)
                    self._pk_src[key] = fp
                old = self._emitted_pk.get(key)
                if old == row:
                    continue
                if old is not None:
                    rows.append((key, old, -1))
                self._emitted_pk[key] = row
                rows.append((key, row, 1))
        else:
            rows = [(int(k), row, 1) for (row, _src), k in zip(entries, keys)]
            if self._track:
                start = 0
                for j in range(1, n + 1):
                    if j == n or owners[j] != owners[start]:
                        self._file_batch[owners[start]] = Batch.from_rows(
                            cols, rows[start:j])
                        start = j
        return concat_batches(retract + [Batch.from_rows(cols, rows)])

    def _read_fast_batch(self, seen, todo, cols) -> list[Batch]:
        """Keyless bulk path: C++ parse each new file, then one columnar
        Batch a file — keys vectorized from (path, index) columns, value
        columns straight from the parser's column lists."""
        out = []
        for fp, mtime in todo:
            try:
                with open(fp, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            seen[fp] = mtime
            col_lists, m = cols_from_bytes(data, self.fmt, self.schema, self.csv_settings)
            if m == 0:
                continue
            c_path = np.empty(m, dtype=object)
            c_path[:] = fp
            c_idx = np.arange(m, dtype=object)  # python ints: hash parity
            keys = keys_for_value_columns([c_path, c_idx], m)
            batch = Batch(keys, {name: _object_col(col_lists[j])
                                 for j, name in enumerate(cols)})
            if self._track:
                self._file_batch[fp] = batch
            out.append(batch)
        return out

    def run(self):
        batch = self._read_all(self._seen)
        self.commit_rows(batch if batch is not None else [])
        if self.mode == "static":
            return
        while not self.should_stop():
            time_mod.sleep(self.refresh_interval)
            batch = self._read_all(self._seen)
            if batch is not None and len(batch):
                self.commit_rows(batch)


def read(
    path: str | os.PathLike,
    *,
    format: str = "csv",  # noqa: A002
    schema: Any | None = None,
    mode: str = "streaming",
    csv_settings: CsvParserSettings | None = None,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    refresh_interval: float = 0.5,
    name: str | None = None,
    **kwargs,
) -> Table:
    if persistent_id is not None:
        raise NotImplementedError(
            "persistent_id needs persistence, which the port does not carry "
            "yet (ROADMAP A13)")
    path = os.fspath(path)
    if format in ("plaintext", "plaintext_by_file"):
        schema = schema_mod.schema_from_types(data=str)
    elif format == "binary":
        schema = schema_mod.schema_from_types(data=bytes)
    elif schema is None:
        raise ValueError("schema is required for csv/json formats")
    if with_metadata:
        schema = schema | schema_mod.schema_from_types(_metadata=dt.JSON)
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"fs({path})")
    conn = _FsConnector(
        node,
        path,
        format,
        schema,
        mode,
        with_metadata,
        csv_settings,
        refresh_interval,
    )
    G.register_connector(conn)
    return Table(node, schema, Universe())


class _FileWriter:
    """A sink's writer: ``start`` opens ``filename`` (with ``.{process_id}``
    when the run has several processes) as a run starts, and keeps it open
    across runs of the same graph as long as the name stays."""

    def __init__(self, filename: str, fmt: str, cols: list[str]):
        self.filename = filename
        self.fmt = fmt
        self.cols = cols
        self._name: str | None = None
        self._f = None
        self._csv = None

    def start(self, config) -> None:
        name = self.filename
        if config.processes > 1:
            # each process writes its own shard (reference cluster mode:
            # every worker owns its output partition)
            name = f"{name}.{config.process_id}"
        if name == self._name:
            return
        if self._f is not None:
            self._f.close()
        self._name = name
        self._f = open(name, "w", encoding="utf-8")  # noqa: SIM115 - lifetime = runs
        if self.fmt == "csv":
            self._csv = csv_mod.writer(self._f)
            self._csv.writerow(self.cols + ["time", "diff"])

    def __call__(self, time, batch) -> None:
        if self._csv is not None:
            for key, row, diff in batch.rows():
                self._csv.writerow([format_value_for_output(v) for v in row] + [time, diff])
        else:
            cols = self.cols
            for key, row, diff in batch.rows():
                obj = {c: format_value_for_output(v) for c, v in zip(cols, row)}
                obj["time"] = time
                obj["diff"] = diff
                self._f.write(json.dumps(obj) + "\n")
        self._f.flush()


def write(table: Table, filename: str | os.PathLike, *, format: str = "json", **kwargs) -> None:  # noqa: A002
    filename = os.fspath(filename)
    writer = _FileWriter(filename, "csv" if format == "csv" else "json",
                         list(table.column_names()))
    node = SinkNode(G.engine_graph, table._node, writer, name=f"fs-write({filename})")
    G.register_sink(node)
