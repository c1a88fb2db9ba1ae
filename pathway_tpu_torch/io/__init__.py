"""``pw.io`` — input/output connectors.

Parity with reference ``python/pathway/io/``: the connector runtime
(threads pumping commit-timed batches into the engine, reference
``src/connectors/``), ``python`` (``ConnectorSubject``), ``kafka`` (an
in-process ``InMemoryKafkaBroker``, or a real cluster through
``confluent_kafka`` where that package is installed), ``http`` (the REST
connector and ``read`` / ``write``), the file connectors (``fs``, ``csv``,
``jsonlines``, ``plaintext``), the object stores (``s3``, ``s3_csv``,
``minio``, ``pyfilesystem``, ``gdrive``), the change streams
(``debezium``, ``deltalake``, ``sqlite``), the sinks (``postgres``,
``mongodb``, ``elasticsearch``, ``bigquery``, ``pubsub``, ``logstash``,
``slack``), ``nats``, ``redpanda`` (the Kafka alias), ``null`` and
``subscribe``. A backend whose client package is absent raises a clear
error at call time; each takes an injected client (``_client=``,
``AwsS3Settings(client=)``, ``connection_factory=``, ``_table=``,
``_provider=``) as JAX's does; ``airbyte`` runs an Airbyte connector (a
local executable, a docker image, a Cloud Run job, or ``_source=``).
"""

from __future__ import annotations

from pathway_tpu_torch.io import (
    airbyte,
    bigquery,
    csv,
    debezium,
    deltalake,
    elasticsearch,
    fs,
    gdrive,
    http,
    jsonlines,
    kafka,
    logstash,
    minio,
    mongodb,
    nats,
    null,
    plaintext,
    postgres,
    pubsub,
    pyfilesystem,
    python,
    redpanda,
    s3,
    s3_csv,
    slack,
    sqlite,
)
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io._utils import CsvParserSettings, OnChangeCallback, OnFinishCallback

__all__ = [
    "CsvParserSettings",
    "airbyte",
    "bigquery",
    "csv",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gdrive",
    "http",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "slack",
    "sqlite",
    "subscribe",
    "OnChangeCallback",
    "OnFinishCallback",
]
