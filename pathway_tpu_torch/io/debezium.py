"""Debezium CDC connector (reference ``python/pathway/io/debezium`` +
``DebeziumMessageParser``, src/connectors/data_format.rs:1053).

Consumes Debezium change envelopes (``payload.op``: c/r = insert, u = update
as delete+insert of the keyed row, d = delete) from a Kafka topic — the
framework's in-memory broker for tests/benchmarks, or a REAL cluster
through the gated ``confluent_kafka`` consumer (same transport as
``pw.io.kafka``, with per-partition offsets as the persistence position).
"""

from __future__ import annotations

import json
from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.io._utils import parse_record_fields
from pathway_tpu_torch.io.kafka import (
    InMemoryKafkaBroker,
    _confluent,
    make_kafka_consumer,
)


class _CdcApplier:
    """Shared CDC envelope → delta translation with the keyed live map
    (the upsert session both transports need)."""

    def __init__(self, node, schema):
        self.schema = schema
        self.cols = list(node.column_names)
        self.dtypes = {n: c.dtype for n, c in schema.__columns__.items()}
        self.pk = schema.primary_key_columns() or ()
        self.live: dict[int, tuple] = {}

    def row_of(self, record: dict):
        from pathway_tpu_torch.engine.value import hash_values

        values = parse_record_fields(record, self.cols, self.dtypes, self.schema)
        src = self.pk or self.cols
        key = hash_values(*[values[c] for c in src])
        return key, tuple(values[c] for c in self.cols)

    def apply(self, value: bytes) -> list[tuple[int, tuple, int]]:
        """Deltas for one envelope (empty for malformed/irrelevant —
        logged, so a misconfigured CDC pipeline is diagnosable, not
        silent data loss)."""
        try:
            env = json.loads(value)
        except (json.JSONDecodeError, TypeError):
            env = None
        payload = env.get("payload", env) if isinstance(env, dict) else None
        if not isinstance(payload, dict):
            from pathway_tpu_torch.internals.errors import get_global_error_log

            get_global_error_log().log(
                "debezium: skipping malformed CDC envelope"
            )
            return []
        op = payload.get("op", "c")
        before, after = payload.get("before"), payload.get("after")
        rows: list[tuple[int, tuple, int]] = []
        if op in ("c", "r") and after:
            key, row = self.row_of(after)
            rows.append((key, row, 1))
            self.live[key] = row
        elif op == "u" and after:
            key, row = self.row_of(after)
            old = self.live.get(key)
            if old is not None:
                rows.append((key, old, -1))
            rows.append((key, row, 1))
            self.live[key] = row
        elif op == "d" and before:
            key, _row = self.row_of(before)
            old = self.live.pop(key, None)
            if old is not None:
                rows.append((key, old, -1))
        return rows

    def replay(self, rows) -> None:
        for key, row, diff in rows:
            if diff > 0:
                self.live[key] = row
            else:
                self.live.pop(key, None)


class _DebeziumConnector(BaseConnector):
    """In-memory broker transport."""

    heartbeat_ms = 500

    def __init__(self, node, broker, topic, schema):
        super().__init__(node)
        self.broker = broker
        self.topic = topic
        self._cdc = _CdcApplier(node, schema)
        self._offset = 0

    # persistence: broker log position + live map rebuilt from replay
    def current_offset(self):
        return self._offset

    def seek_offset(self, offset) -> None:
        if isinstance(offset, int):
            self._offset = offset

    def on_replay(self, rows) -> None:
        self._cdc.replay(rows)

    def run(self):
        import time as time_mod

        while not self.should_stop():
            msgs = self.broker.poll(self.topic, self._offset)
            self._offset += len(msgs)
            rows = []
            for _mkey, value in msgs:
                rows.extend(self._cdc.apply(value))
            if rows:
                self.commit_rows(rows)
            elif self.broker.closed:
                return
            else:
                time_mod.sleep(0.01)


class _DebeziumKafkaConnector(BaseConnector):
    """Real-cluster transport: the gated confluent_kafka consumer loop of
    ``pw.io.kafka`` feeding the shared CDC applier; per-partition offsets
    are the persistence position."""

    heartbeat_ms = 500
    MAX_DRAIN = 1024

    def __init__(self, node, settings: dict, topic: str, schema,
                 poll_timeout_s: float = 0.2):
        super().__init__(node)
        self.settings = dict(settings)
        self.topic = topic
        self._cdc = _CdcApplier(node, schema)
        self.poll_timeout_s = poll_timeout_s
        self._positions: dict[int, int] = {}
        self._seek_to: dict[int, int] = {}

    def current_offset(self):
        return dict(self._positions)

    def seek_offset(self, offset) -> None:
        if isinstance(offset, dict):
            self._seek_to = {int(p): int(o) for p, o in offset.items()}
            self._positions.update(self._seek_to)

    def on_replay(self, rows) -> None:
        self._cdc.replay(rows)

    def run(self):
        consumer = make_kafka_consumer(
            self.settings, self.topic, self._seek_to, start_from_latest=False
        )
        try:
            while not self.should_stop():
                msg = consumer.poll(self.poll_timeout_s)
                if msg is None:
                    continue
                rows: list = []
                n = 0
                while msg is not None and n < self.MAX_DRAIN:
                    if msg.error():
                        from pathway_tpu_torch.internals.errors import (
                            get_global_error_log,
                        )

                        get_global_error_log().log(
                            f"debezium kafka error: {msg.error()}"
                        )
                    else:
                        rows.extend(self._cdc.apply(msg.value()))
                        self._positions[msg.partition()] = msg.offset()
                    n += 1
                    msg = consumer.poll(0)
                if rows:
                    self.commit_rows(rows)
        finally:
            consumer.close()


def read(
    rdkafka_settings: dict | InMemoryKafkaBroker,
    topic_name: str,
    *,
    schema: Any,
    db_type: str = "postgres",
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    **kwargs,
) -> Table:
    """Read a Debezium CDC stream into an upserted table — from an
    ``InMemoryKafkaBroker`` or a real cluster (``rdkafka_settings`` dict,
    gated on ``confluent_kafka`` like ``pw.io.kafka``)."""
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"debezium({topic_name})")
    if isinstance(rdkafka_settings, InMemoryKafkaBroker):
        conn = _DebeziumConnector(node, rdkafka_settings, topic_name, schema)
    elif isinstance(rdkafka_settings, dict):
        _confluent()  # fail fast with a clear error when the client is absent
        conn = _DebeziumKafkaConnector(node, rdkafka_settings, topic_name, schema)
    else:
        raise TypeError(
            f"rdkafka_settings must be a settings dict or an "
            f"InMemoryKafkaBroker, got {type(rdkafka_settings).__name__}"
        )
    G.register_connector(conn)
    table = Table(node, schema, Universe())
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return table
