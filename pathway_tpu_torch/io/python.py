"""Python connector — ``ConnectorSubject`` (reference ``python/pathway/io/python``).

A user-provided subject runs on its own thread pushing rows via
``next``/``next_json``/``next_str``/``next_bytes`` and ``commit``; the
connector converts them into commit-timed engine batches.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.io._utils import parse_record_fields


class ConnectorSubject(ABC):
    """Subclass and implement ``run``; call ``self.next(**values)`` to emit
    rows and ``self.commit()`` to advance time."""

    _connector: "_PythonConnector | None" = None

    def __init__(self, datasource_name: str | None = None):
        self._buffer: list[tuple[Any, dict, int]] = []  # (key_override, values, diff)

    # ---- user-facing emit API -------------------------------------------
    def next(self, **kwargs) -> None:
        self._buffer.append((None, kwargs, 1))

    def next_json(self, message: dict | str) -> None:
        if isinstance(message, str):
            message = json.loads(message)
        self.next(**message)

    def next_str(self, message: str) -> None:
        self._buffer.append((None, {"data": message}, 1))

    def next_bytes(self, message: bytes) -> None:
        self._buffer.append((None, {"data": message}, 1))

    def _remove(self, key, values: dict) -> None:
        self._buffer.append((key, values, -1))

    def commit(self) -> None:
        if self._connector is not None:
            self._connector.flush(self._buffer)
        self._buffer = []

    def close(self) -> None:
        self.commit()

    def on_stop(self) -> None:
        pass

    @abstractmethod
    def run(self) -> None: ...

    @property
    def _deletions_enabled(self) -> bool:
        return True


class _PythonConnector(BaseConnector):
    heartbeat_ms = 500

    def __init__(self, node, subject: ConnectorSubject, schema):
        super().__init__(node)
        self.subject = subject
        self.schema = schema
        self._counter = 0
        self._emitted_keys: dict[int, tuple] = {}
        self._processed = 0  # persistence offset: entries consumed so far
        self._skip = 0

    # persistence: offset = number of subject entries consumed; on resume the
    # subject's deterministic replay is skipped up to it (snapshot replay
    # restores the data itself — reference PythonReader + SnapshotEvent log)
    def current_offset(self):
        return self._processed

    def seek_offset(self, offset) -> None:
        if isinstance(offset, int):
            self._skip = offset
            self._processed = offset
            self._counter = offset

    def on_replay(self, rows) -> None:
        # rebuild the upsert map so post-restart updates/removals retract the
        # replayed row rather than duplicating its key
        if self.schema.primary_key_columns():
            for key, row, diff in rows:
                if diff > 0:
                    self._emitted_keys[key] = row

    def flush(self, buffer: list[tuple[Any, dict, int]]) -> None:
        if self._skip > 0:
            n = min(self._skip, len(buffer))
            self._skip -= n
            buffer = buffer[n:]
            if not buffer:
                return
        cols = list(self.node.column_names)
        dtypes = {n: c.dtype for n, c in self.schema.__columns__.items()}
        pk = self.schema.primary_key_columns()
        rows = []
        for key_override, values, diff in buffer:
            self._processed += 1
            parsed = parse_record_fields(values, cols, dtypes, self.schema)
            if key_override is not None:
                key = key_override
            elif pk:
                key = hash_values(*[parsed[c] for c in pk])
            else:
                key = hash_values(self._counter)
                self._counter += 1
            row = tuple(parsed[c] for c in cols)
            if diff > 0 and pk:
                # upsert semantics for keyed python sources (SessionType::Upsert)
                old = self._emitted_keys.get(key)
                if old is not None:
                    rows.append((key, old, -1))
                self._emitted_keys[key] = row
            elif diff < 0 and key in self._emitted_keys:
                row = self._emitted_keys.pop(key)
            rows.append((key, row, diff))
        self.commit_rows(rows)

    def run(self):
        self.subject._connector = self
        try:
            self.subject.run()
            self.subject.commit()
        finally:
            self.subject.on_stop()

    # stop(): BaseConnector sets the stop event and joins; subjects observe
    # it via should_stop()/their own loops, and run()'s finally invokes
    # on_stop exactly once


def read(
    subject: ConnectorSubject,
    *,
    schema: Any,
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    name: str | None = None,
    **kwargs,
) -> Table:
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name="python-connector")
    conn = _PythonConnector(node, subject, schema)
    G.register_connector(conn)
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return Table(node, schema, Universe())


class InteractiveCsvPlayer(ConnectorSubject):
    """Jupyter-widget CSV stepper (reference ``io/python/__init__.py:472``):
    a slider releases CSV rows into the stream as it advances. Without
    ``panel`` / ``IPython`` it plays the whole file at once, as JAX's."""

    def __init__(self, csv_file: str = "") -> None:
        super().__init__()
        import queue

        import pandas as pd

        self.q: "queue.Queue" = queue.Queue()
        self.df = pd.read_csv(csv_file)
        self._widgets = False
        try:
            import panel as pn
            from IPython.display import display

            state = pn.widgets.Spinner(value=0, width=0)
            int_slider = pn.widgets.IntSlider(name="Row position in csv", start=0,
                                              end=len(self.df), step=1, value=0)

            def updatecallback(target, event):
                if event.new > event.old:
                    target.value = event.new
                    self.q.put_nowait(target.value)

            int_slider.link(state, callbacks={"value": updatecallback})
            self.state = state
            self.int_slider = int_slider
            display(pn.Row(state, int_slider, f"{len(self.df)} rows in csv"))
            self._widgets = True
        except Exception:
            # headless (no panel / IPython, or no notebook): release everything
            self.q.put_nowait(len(self.df))

    def run(self) -> None:
        import queue

        last_streamed_idx = -1
        while True:
            try:
                new_pos = self.q.get(timeout=0.5)
            except queue.Empty:
                if not self._widgets:
                    break
                c = self._connector
                if c is not None and c.should_stop():
                    break
                continue
            for i in range(last_streamed_idx + 1, min(new_pos, len(self.df))):
                self.next(**self.df.iloc[i].to_dict())
            self.commit()
            last_streamed_idx = max(last_streamed_idx, new_pos - 1)
            if last_streamed_idx >= len(self.df) - 1:
                break
        self.close()
