"""``pw.io`` — input/output connectors.

Parity with reference ``python/pathway/io/``: the connector runtime
(threads pumping commit-timed batches into the engine, reference
``src/connectors/``), ``python`` (``ConnectorSubject``), ``kafka`` (an
in-process ``InMemoryKafkaBroker``, or a real cluster through
``confluent_kafka`` where that package is installed), ``http`` (the REST
connector), the file connectors (``fs``, ``csv``, ``jsonlines``,
``plaintext``), ``null`` and ``subscribe``. The other backends are not
ported yet (ROADMAP A13).
"""

from __future__ import annotations

from pathway_tpu_torch.io import csv, fs, http, jsonlines, kafka, null, plaintext, python
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io._utils import CsvParserSettings, OnChangeCallback, OnFinishCallback

__all__ = [
    "CsvParserSettings",
    "csv",
    "fs",
    "http",
    "jsonlines",
    "kafka",
    "null",
    "plaintext",
    "python",
    "subscribe",
    "OnChangeCallback",
    "OnFinishCallback",
]
