"""Global graph state ``G``.

The reference builds a Python operator DAG (``internals/parse_graph.py``) that
is lowered per worker at run time. Here table operations build engine nodes
eagerly (the engine graph itself is lazy — nothing executes until run), so
``G`` tracks the engine graph plus run-relevant endpoints: static input data,
live connectors, sinks/subscribers.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.graph import EngineGraph, Node


class ParseGraph:
    def __init__(self):
        self.engine_graph = EngineGraph()
        # InputNode -> callable() -> Batch  (static data, injected at t=0)
        self.static_sources: dict[int, tuple[Node, Callable]] = {}
        # streaming connectors: objects with .start(scheduler, node) / .stop()
        self.connectors: list[Any] = []
        # sink/subscribe nodes that must be pumped on run
        self.sinks: list[Node] = []
        self._op_cache: dict[Any, Any] = {}

    def register_static_source(self, node: Node, provider: Callable) -> None:
        self.static_sources[node.id] = (node, provider)

    def register_connector(self, connector: Any) -> None:
        self.connectors.append(connector)

    def register_sink(self, node: Node) -> None:
        self.sinks.append(node)

    def clear(self) -> None:
        self.__init__()
        from pathway_tpu_torch import persistence

        persistence._persistent_sources.clear()


G = ParseGraph()


def clear_graph() -> None:
    G.clear()
