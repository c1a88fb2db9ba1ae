"""NATS connector (reference ``python/pathway/io/nats``; engine
``NatsReader``/``NatsWriter`` data_storage.rs:2271,2345). Gated on
``nats-py``."""

from __future__ import annotations

import json
from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.io._utils import format_value_for_output


def _require_nats():
    try:
        import nats  # noqa: F401

        return nats
    except ImportError as exc:  # pragma: no cover - gated dependency
        raise ImportError("pw.io.nats requires the `nats-py` package") from exc


class _NatsConnector(BaseConnector):
    """Live NATS subscription (reference ``NatsReader``,
    data_storage.rs:2271): the connector thread runs its own asyncio loop,
    subscribes to the subject, and drains arriving messages into batched
    commits through the shared stream parser. Core NATS has no replayable
    log, so the source is non-seekable (persistence relies on replay
    alone, like the python ConnectorSubject)."""

    heartbeat_ms = 500

    def __init__(self, node, nats_mod, uri: str, topic: str, schema,
                 fmt: str, queue: str | None = None):
        super().__init__(node)
        self.nats_mod = nats_mod
        self.uri = uri
        self.topic = topic
        self.schema = schema
        self.fmt = fmt
        self.queue = queue
        self._counter = 0

    # persistence: the arrival counter is the offset — a restart must keep
    # numbering AFTER the replayed rows or fresh messages would reuse
    # replayed keys (duplicate-key corruption); same contract as the
    # python ConnectorSubject
    def current_offset(self):
        return self._counter

    def seek_offset(self, offset) -> None:
        if isinstance(offset, int):
            self._counter = offset

    def run(self):
        import asyncio
        import queue as queue_mod

        from pathway_tpu_torch.io._utils import (
            batch_parse_stream_records,
            stream_parse_plan,
        )

        cols = list(self.node.column_names)
        dtypes = {n: c.dtype for n, c in self.schema.__columns__.items()}
        plan = stream_parse_plan(self.schema, cols, dtypes)
        pk = self.schema.primary_key_columns() or ()
        pk_idx = [cols.index(c) for c in pk]
        inbox: queue_mod.Queue = queue_mod.Queue()

        async def pump():
            nc = await self.nats_mod.connect(self.uri)
            try:
                async def on_msg(msg):
                    inbox.put(msg.data)

                sub_kwargs = {"cb": on_msg}
                if self.queue:
                    sub_kwargs["queue"] = self.queue
                await nc.subscribe(self.topic, **sub_kwargs)
                while not self.should_stop():
                    await asyncio.sleep(0.05)
            finally:
                await nc.close()

        import threading

        pump_err: list = []

        def run_loop():
            try:
                asyncio.run(pump())
            except Exception as exc:  # noqa: BLE001 - surfaced below
                pump_err.append(exc)

        t = threading.Thread(target=run_loop, daemon=True,
                             name=f"pathway:nats-{self.topic}")
        t.start()
        while not self.should_stop():
            values = []
            try:
                values.append(inbox.get(timeout=0.1))
            except queue_mod.Empty:
                if pump_err:
                    raise pump_err[0]
                continue
            while len(values) < 1024:
                try:
                    values.append(inbox.get_nowait())
                except queue_mod.Empty:
                    break
            if self.fmt == "plaintext":
                parsed: list = [
                    (v.decode("utf-8", errors="replace"),) for v in values
                ]
            else:
                parsed = batch_parse_stream_records(
                    values, self.fmt, self.schema, cols, dtypes, plan=plan
                )
            rows = []
            for row in parsed:
                if row is None:
                    from pathway_tpu_torch.internals.errors import (
                        get_global_error_log,
                    )

                    get_global_error_log().log(
                        f"nats: skipping malformed message on {self.topic}"
                    )
                    continue
                if pk:
                    key = hash_values(*[row[j] for j in pk_idx])
                else:
                    # arrival-order keys: core NATS has no stable offsets
                    key = hash_values(self.topic, self._counter)
                    self._counter += 1
                rows.append((key, row, 1))
            if rows:
                self.commit_rows(rows)
        t.join(timeout=5.0)


def read(uri: str, topic: str, *, schema: Any = None,
         format: str = "json", queue: str | None = None,  # noqa: A002
         persistent_id: str | None = None, **kwargs) -> Table:
    """Subscribe to a NATS subject as a live stream (reference
    ``io/nats``); gated on ``nats-py``. ``format``: json (schema
    required), plaintext, or raw."""
    nats_mod = _require_nats()
    from pathway_tpu_torch.internals import schema as schema_mod

    if format == "raw":
        schema = schema_mod.schema_from_types(data=bytes)
    elif format == "plaintext":
        schema = schema_mod.schema_from_types(data=str)
    elif schema is None:
        raise ValueError("schema is required for json-format NATS reads")
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"nats({topic})")
    conn = _NatsConnector(node, nats_mod, uri, topic, schema, format,
                          queue=queue)
    G.register_connector(conn)
    table = Table(node, schema, Universe())
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return table


def write(table, uri: str, topic: str, *, format: str = "json",  # noqa: A002
          _client=None, **kwargs) -> None:
    """``_client`` (sync ``.publish(subject, payload_bytes)``) is injectable
    for offline tests; the real path connects an async nats client."""
    if _client is None:
        nats_mod = _require_nats()
    import asyncio

    cols = list(table.column_names())
    state: dict = {}

    def _connect():
        if "nc" not in state:
            loop = asyncio.new_event_loop()
            nc = loop.run_until_complete(nats_mod.connect(uri))
            state["nc"] = nc
            state["loop"] = loop
        return state["nc"], state["loop"]

    def write_batch(time, batch):
        for _key, row, diff in batch.rows():
            payload = {c: format_value_for_output(v) for c, v in zip(cols, row)}
            payload["diff"] = diff
            data = json.dumps(payload).encode()
            if _client is not None:
                _client.publish(topic, data)
            else:
                nc, loop = _connect()
                loop.run_until_complete(nc.publish(topic, data))

    node = SinkNode(G.engine_graph, table._node, write_batch, name=f"nats({topic})")
    G.register_sink(node)
