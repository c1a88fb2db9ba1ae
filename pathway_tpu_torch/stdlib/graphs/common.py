"""Graph schema vocabulary (reference ``stdlib/graphs/common.py``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.api import Pointer
from pathway_tpu_torch.internals.schema import Schema


class Vertex(Schema):
    pass


class Edge(Schema):
    """An edge holds pointers to its endpoint vertices."""

    u: Pointer[Any]
    v: Pointer[Any]


class Weight(Schema):
    """Weight column mixin for Vertex / Edge tables."""

    weight: float


class Cluster(Vertex, Schema):
    pass


class Clustering(Schema):
    """Cluster membership: vertex (row id) belongs to cluster ``c``."""

    c: Pointer[Any]


class Dist(Schema):
    """Edge length for shortest paths (reference ``bellman_ford/impl.py``)."""

    dist: float


class DistFromSource(Schema):
    dist_from_source: float


class PageRankResult(Schema):
    """Reference ``pagerank/impl.py:Result`` (rank is a damped probability
    mass, a float)."""

    rank: float
