"""Redpanda connector — Kafka-protocol alias (reference
``python/pathway/io/redpanda/__init__.py``: same reader/writer as
``pw.io.kafka`` pointed at a Redpanda cluster)."""

from __future__ import annotations

from pathway_tpu_torch.io.kafka import InMemoryKafkaBroker, read, write

__all__ = ["read", "write", "InMemoryKafkaBroker"]
