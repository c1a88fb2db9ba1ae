"""Kafka connector (reference ``python/pathway/io/kafka`` +
``src/connectors/data_storage.rs:692,1258`` KafkaReader/KafkaWriter).

Two backends behind one API:

* a dict of ``rdkafka_settings`` drives a REAL ``confluent_kafka``
  Consumer/Producer (gated import — the library is not in the baked image,
  but any environment that has it, or a test that injects a stub module into
  ``sys.modules``, gets the full read/write/seek path);
* an in-process :class:`InMemoryKafkaBroker` models streaming ingest for
  tests and benchmarks without a cluster.

With ``persistent_id=`` the reader's offset is the broker log position (the
in-memory broker) or the per-partition position map (a real consumer),
stored with every snapshot chunk, as in JAX.
"""

from __future__ import annotations

import threading
import time as time_mod
from collections import defaultdict
from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector


class InMemoryKafkaBroker:
    """Minimal in-process topic/partition log usable as ``rdkafka_settings``
    for local testing and throughput benchmarks."""

    def __init__(self):
        self._topics: dict[str, list[tuple[bytes | None, bytes]]] = defaultdict(list)
        self._lock = threading.Lock()
        self._closed = False

    def produce(self, topic: str, value: bytes, key: bytes | None = None) -> None:
        with self._lock:
            self._topics[topic].append((key, value))

    def close(self) -> None:
        self._closed = True

    def poll(self, topic: str, offset: int) -> list[tuple[bytes | None, bytes]]:
        with self._lock:
            return self._topics[topic][offset:]

    @property
    def closed(self) -> bool:
        return self._closed


class _BrokerConnector(BaseConnector):
    heartbeat_ms = 500

    def __init__(self, node, broker: InMemoryKafkaBroker, topic: str, schema, fmt: str,
                 start_from_latest: bool = False):
        super().__init__(node)
        self.broker = broker
        self.topic = topic
        self.schema = schema
        self.fmt = fmt
        self.start_from_latest = start_from_latest
        self._offset = 0
        self._started = False
        # primary-keyed topics are upsert sessions (see run())
        self._emitted_pk: dict[int, tuple] = {}

    def on_replay(self, rows) -> None:
        if self.schema.primary_key_columns():
            for key, row, diff in rows:
                if diff > 0:
                    self._emitted_pk[key] = row
                else:
                    self._emitted_pk.pop(key, None)

    # persistence: the broker log position IS the reader offset — stored
    # with every snapshot chunk so a restart resumes past replayed data
    # instead of re-reading the topic from 0 (which would double every row)
    def current_offset(self):
        return self._offset

    def seek_offset(self, offset) -> None:
        if isinstance(offset, int):
            self._offset = offset

    def run(self):
        from pathway_tpu_torch.io._utils import (
            batch_parse_stream_records,
            stream_parse_plan,
        )

        if self.start_from_latest and self._offset == 0:
            self._offset = len(self.broker.poll(self.topic, 0))
        cols = list(self.node.column_names)
        dtypes = {n: c.dtype for n, c in self.schema.__columns__.items()}
        plan = stream_parse_plan(self.schema, cols, dtypes)
        pk = self.schema.primary_key_columns() or ()
        pk_idx = [cols.index(c) for c in pk]
        while not self.should_stop():
            entries = self.broker.poll(self.topic, self._offset)
            if entries:
                base = self._offset
                # whole drained poll parses as ONE batch (chunked
                # json.loads + C++ row extraction); undecodable or
                # non-record messages skip instead of killing the stream
                parsed = batch_parse_stream_records(
                    [v for _k, v in entries], self.fmt, self.schema,
                    cols, dtypes, plan=plan,
                )
                good: list[tuple] = []
                offs: list[int] = []
                for i, row in enumerate(parsed):
                    if row is None:
                        from pathway_tpu_torch.internals.errors import (
                            get_global_error_log,
                        )

                        get_global_error_log().log(
                            f"kafka broker: skipping malformed message at "
                            f"offset {base + i}"
                        )
                        continue
                    good.append(row)
                    offs.append(base + i)
                # key derivation is ONE vectorized Key::for_values pass per
                # poll (identical values to per-row hash_values) — per-row
                # hashing dominated ingress at high rates
                if good:
                    import numpy as np

                    from pathway_tpu_torch.engine.value import (
                        keys_for_value_columns,
                    )

                    n = len(good)
                    if pk:
                        # np.empty + slice-assign keeps list/array-valued pk
                        # columns as 1-D object arrays (np.array(...) would
                        # collapse equal-length lists into a 2-D array and
                        # change row identities vs hash_values)
                        key_cols = []
                        for j in pk_idx:
                            col = np.empty(n, dtype=object)
                            col[:] = [r[j] for r in good]
                            key_cols.append(col)
                    else:
                        # log-position keys: stable across restarts
                        key_cols = [
                            np.full(n, self.topic, dtype=object),
                            np.array(offs, dtype=object),
                        ]
                    keys = keys_for_value_columns(key_cols, n).tolist()
                    if pk:
                        # primary-keyed topics are upsert sessions
                        # (reference SessionType::Upsert): a re-delivered
                        # key retracts the previous row instead of
                        # violating the universe key invariant
                        rows = []
                        emitted = self._emitted_pk
                        for k, row in zip(keys, good):
                            old = emitted.get(k)
                            if old == row:
                                continue
                            if old is not None:
                                rows.append((k, old, -1))
                            emitted[k] = row
                            rows.append((k, row, 1))
                    else:
                        rows = [
                            (k, row, 1) for k, row in zip(keys, good)
                        ]
                else:
                    rows = []
                self._offset = base + len(entries)
                self.commit_rows(rows)
            elif self.broker.closed:
                return
            else:
                time_mod.sleep(0.01)


def _confluent():
    """Gated confluent_kafka import (same pattern as postgres/mongo/gdrive):
    importable -> real client; otherwise a clear error. Tests exercise the
    real code path by injecting a stub module into ``sys.modules``."""
    try:
        import confluent_kafka  # type: ignore

        return confluent_kafka
    except ImportError as exc:
        raise ImportError(
            "reading a real Kafka cluster requires the confluent_kafka "
            "client, which is not available in this environment; pass an "
            "InMemoryKafkaBroker for in-process streaming"
        ) from exc


def make_kafka_consumer(settings: dict, topic: str,
                        seek_to: dict[int, int] | None,
                        start_from_latest: bool):
    """A subscribed confluent_kafka Consumer with the framework defaults:
    unique per-run group.id (a shared default group would make two
    independent pipelines on the same topic split partitions and each
    silently see half the data — the reference always takes group.id from
    rdkafka_settings), manual commits, and per-partition seek applied
    inside on_assign so partitions NOT in the saved map still flow."""
    import uuid

    ck = _confluent()
    settings = dict(settings)
    settings.setdefault("group.id", f"pathway-{topic}-{uuid.uuid4().hex[:12]}")
    settings.setdefault(
        "auto.offset.reset", "latest" if start_from_latest else "earliest"
    )
    settings.setdefault("enable.auto.commit", "false")
    consumer = ck.Consumer(settings)
    if seek_to:
        def on_assign(cons, partitions):
            for p in partitions:
                if p.partition in seek_to:
                    p.offset = seek_to[p.partition] + 1
            cons.assign(partitions)

        consumer.subscribe([topic], on_assign=on_assign)
    else:
        consumer.subscribe([topic])
    return consumer


class _KafkaConnector(BaseConnector):
    """Real consumer loop (reference ``KafkaReader::read``,
    ``data_storage.rs:692``): poll -> parse -> commit at a fresh engine time;
    the reader offset stored with each snapshot chunk is the per-partition
    position map, and ``seek_offset`` resumes past replayed data."""

    heartbeat_ms = 500

    def __init__(self, node, settings: dict, topic: str, schema, fmt: str,
                 start_from_latest: bool = False, poll_timeout_s: float = 0.2):
        super().__init__(node)
        self.settings = dict(settings)
        self.topic = topic
        self.schema = schema
        self.fmt = fmt
        self.start_from_latest = start_from_latest
        self.poll_timeout_s = poll_timeout_s
        self._positions: dict[int, int] = {}  # partition -> next offset
        self._seek_to: dict[int, int] = {}
        self._consumer = None

    # -- persistence hooks (per-partition offsets, the analog of the
    # reference's OffsetAntichain for Kafka sources) ------------------------
    def current_offset(self):
        return dict(self._positions)

    def seek_offset(self, offset) -> None:
        if isinstance(offset, dict):
            self._seek_to = {int(p): int(o) for p, o in offset.items()}
            self._positions.update(self._seek_to)

    def _make_consumer(self):
        return make_kafka_consumer(
            self.settings, self.topic, self._seek_to, self.start_from_latest
        )

    def _parse(self, msg, cols, dtypes, pk):
        """(key, row) or None for malformed payloads (logged, skipped —
        one bad message must not kill the stream)."""
        from pathway_tpu_torch.io._utils import parse_stream_record

        try:
            values = parse_stream_record(
                msg.value(), self.fmt, self.schema, cols, dtypes
            )
            if values is None:
                raise ValueError("undecodable json payload")
            if pk:
                key = hash_values(*[values[c] for c in pk])
            else:
                # offset-based keys: deterministic across restarts so
                # replay + reread can never duplicate a message
                key = hash_values(self.topic, msg.partition(), msg.offset())
            return key, tuple(values[c] for c in cols)
        except Exception as exc:  # noqa: BLE001
            from pathway_tpu_torch.internals.errors import get_global_error_log

            get_global_error_log().log(
                f"kafka: skipping malformed message at "
                f"{msg.partition()}:{msg.offset()}: {exc!r}"
            )
            return None

    MAX_DRAIN = 1024  # messages per commit: amortize commit-time/snapshot cost

    def run(self):
        self._consumer = self._make_consumer()
        cols = list(self.node.column_names)
        dtypes = {n: c.dtype for n, c in self.schema.__columns__.items()}
        pk = self.schema.primary_key_columns()
        try:
            while not self.should_stop():
                msg = self._consumer.poll(self.poll_timeout_s)
                if msg is None:
                    continue
                # drain everything already buffered into ONE commit
                rows = []
                while msg is not None and len(rows) < self.MAX_DRAIN:
                    if msg.error():
                        from pathway_tpu_torch.internals.errors import (
                            get_global_error_log,
                        )

                        get_global_error_log().log(f"kafka error: {msg.error()}")
                    else:
                        parsed = self._parse(msg, cols, dtypes, pk)
                        if parsed is not None:
                            rows.append((parsed[0], parsed[1], 1))
                        self._positions[msg.partition()] = msg.offset()
                    msg = self._consumer.poll(0)
                if rows:
                    self.commit_rows(rows)
        finally:
            self._consumer.close()


def read(
    rdkafka_settings: Any,
    topic: str | None = None,
    *,
    schema: Any | None = None,
    format: str = "json",  # noqa: A002
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    start_from_latest: bool = False,
    **kwargs,
) -> Table:
    """Read a Kafka topic as a streaming table.

    Memory contract: when ``schema`` declares primary-key columns the
    reader runs an upsert session — it must retract the previous row for
    a re-delivered key, so it retains the last-emitted row tuple for
    EVERY live primary key for the life of the connector (host memory
    ~ keyspace x row width). Unavoidable for upsert retraction
    semantics; for unbounded-cardinality topics, prefer an append-only
    schema (no primary key) and deduplicate downstream where state can
    be compacted by temporal behaviors.

    Reference parity: ``io/kafka/__init__.py`` read() in the reference
    (session-type selection from the schema's primary key).
    """
    from pathway_tpu_torch.internals import schema as schema_mod

    if format == "raw":
        schema = schema_mod.schema_from_types(data=bytes)
    if schema is None:
        raise ValueError("schema is required for json-format Kafka reads")
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"kafka({topic})")
    if isinstance(rdkafka_settings, InMemoryKafkaBroker):
        conn = _BrokerConnector(node, rdkafka_settings, topic, schema, format,
                                start_from_latest=start_from_latest)
    elif isinstance(rdkafka_settings, dict):
        _confluent()  # fail fast with a clear error when the client is absent
        conn = _KafkaConnector(node, rdkafka_settings, topic, schema, format,
                               start_from_latest=start_from_latest)
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


def read_from_upstash(
    endpoint: str,
    username: str,
    password: str,
    topic: str,
    *,
    read_only_new: bool = False,
    schema=None,
    format: str = "raw",  # noqa: A002
    **kwargs,
) -> Table:
    """Read from Upstash-hosted Kafka (reference ``io/kafka/__init__.py``
    upstash wrapper): SASL-SCRAM settings over the standard reader."""
    rdkafka_settings = {
        "bootstrap.servers": endpoint,
        "security.protocol": "SASL_SSL",
        "sasl.mechanism": "SCRAM-SHA-256",
        "sasl.username": username,
        "sasl.password": password,
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(rdkafka_settings, topic=topic, schema=schema, format=format,
                start_from_latest=read_only_new, **kwargs)


def simple_read(
    server: Any,
    topic: str,
    *,
    read_only_new: bool = False,
    schema=None,
    format: str = "raw",  # noqa: A002
    autocommit_duration_ms: int | None = 1500,
    json_field_paths: dict | None = None,
    parallel_readers: int | None = None,
    persistent_id: str | None = None,
    **kwargs,
) -> Table:
    """Read from Kafka with just a server address (or an
    ``InMemoryKafkaBroker``) and a topic (reference
    ``io/kafka/__init__.py:299``); starts from the beginning unless
    ``read_only_new``."""
    if isinstance(server, InMemoryKafkaBroker):
        return read(server, topic=topic, schema=schema, format=format,
                    autocommit_duration_ms=autocommit_duration_ms,
                    persistent_id=persistent_id, start_from_latest=read_only_new, **kwargs)
    rdkafka_settings = {
        "bootstrap.servers": server,
        "session.timeout.ms": "60000",
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(rdkafka_settings, topic=topic, schema=schema, format=format,
                autocommit_duration_ms=autocommit_duration_ms,
                json_field_paths=json_field_paths, parallel_readers=parallel_readers,
                persistent_id=persistent_id, **kwargs)


def write(
    table: Table,
    rdkafka_settings: Any,
    topic_name: str | None = None,
    *,
    format: str = "json",  # noqa: A002
    **kwargs,
) -> None:
    import json

    cols = list(table.column_names())

    def encode_row(row, diff) -> bytes:
        from pathway_tpu_torch.io._utils import format_value_for_output

        if format == "raw":
            (v,) = row
            return v if isinstance(v, bytes) else str(v).encode()
        obj = {c: format_value_for_output(v) for c, v in zip(cols, row)}
        obj["diff"] = diff
        return json.dumps(obj).encode()

    if isinstance(rdkafka_settings, InMemoryKafkaBroker):

        def write_batch(time, batch):
            for key, row, diff in batch.rows():
                rdkafka_settings.produce(topic_name, encode_row(row, diff))

    elif isinstance(rdkafka_settings, dict):
        ck = _confluent()
        producer = ck.Producer(dict(rdkafka_settings))

        def write_batch(time, batch):
            # reference KafkaWriter (data_storage.rs:1258): produce the
            # batch, then flush so a commit is durable before the frontier
            # advances past it
            for key, row, diff in batch.rows():
                producer.produce(topic_name, encode_row(row, diff))
            producer.flush()

    else:
        raise TypeError(
            f"rdkafka_settings must be a settings dict or an "
            f"InMemoryKafkaBroker, got {type(rdkafka_settings).__name__}"
        )
    node = SinkNode(G.engine_graph, table._node, write_batch, name=f"kafka-write({topic_name})")
    G.register_sink(node)
