"""Null sink (reference ``python/pathway/io/null``)."""

from __future__ import annotations

from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.parse_graph import G


def write(table, **kwargs) -> None:
    node = SinkNode(G.engine_graph, table._node, lambda t, b: None, name="null-sink")
    G.register_sink(node)
