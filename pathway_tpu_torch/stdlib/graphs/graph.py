"""Graph / WeightedGraph containers with cluster contraction
(reference ``stdlib/graphs/graph.py``)."""

from __future__ import annotations

from dataclasses import dataclass

from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.stdlib.graphs.common import Clustering, Edge, Vertex, Weight


def _extended_to_full_clustering(vertices, clustering):
    """Extend a partial clustering so unassigned vertices form singleton
    clusters keyed by their own id."""
    return vertices.select(c=vertices.id).update_rows(clustering)


def _contract(edges, clustering):
    """Contract clusters: one vertex per cluster; edges re-pointed to the
    clusters containing their endpoints."""
    grouped = clustering.groupby(clustering.c).reduce(v=clustering.c)
    new_vertices = grouped.with_id(grouped.v).select()
    new_edges = edges.select(u=clustering.ix(edges.u).c, v=clustering.ix(edges.v).c)
    return Graph(new_vertices, new_edges)


def _contract_weighted(edges, clustering):
    g = _contract(edges, clustering)
    new_edges = edges.select(
        u=clustering.ix(edges.u).c,
        v=clustering.ix(edges.v).c,
        weight=edges.weight,
    )
    return WeightedGraph.from_vertices_and_weighted_edges(g.V, new_edges)


@dataclass
class Graph:
    """Undirected, unweighted (multi)graph."""

    V: object
    E: object

    def contracted_to_multi_graph(self, clustering):
        full = _extended_to_full_clustering(self.V, clustering)
        return _contract(self.E, full)

    def contracted_to_unweighted_simple_graph(self, clustering, **reducer_expressions):
        contracted = self.contracted_to_multi_graph(clustering)
        contracted.E = contracted.E.groupby(contracted.E.u, contracted.E.v).reduce(
            contracted.E.u, contracted.E.v
        )
        return contracted

    def contracted_to_weighted_simple_graph(self, clustering, **reducer_expressions):
        contracted = self.contracted_to_multi_graph(clustering)
        WE = contracted.E.groupby(contracted.E.u, contracted.E.v).reduce(
            contracted.E.u, contracted.E.v, **reducer_expressions
        )
        return WeightedGraph.from_vertices_and_weighted_edges(contracted.V, WE)

    def without_self_loops(self):
        return Graph(self.V, self.E.filter(self.E.u != self.E.v))


@dataclass
class WeightedGraph(Graph):
    """Undirected weighted (multi)graph; ``WE`` carries u, v, weight."""

    WE: object = None

    @staticmethod
    def from_vertices_and_weighted_edges(V, WE):
        return WeightedGraph(V, WE, WE)

    def contracted_to_multi_graph(self, clustering):
        full = _extended_to_full_clustering(self.V, clustering)
        return _contract_weighted(self.WE, full)

    def contracted_to_weighted_simple_graph(self, clustering, **reducer_expressions):
        contracted = self.contracted_to_multi_graph(clustering)
        contracted.WE = contracted.WE.groupby(
            contracted.WE.u, contracted.WE.v
        ).reduce(contracted.WE.u, contracted.WE.v, **reducer_expressions)
        return contracted

    def without_self_loops(self):
        return WeightedGraph.from_vertices_and_weighted_edges(
            self.V, self.WE.filter(self.WE.u != self.WE.v)
        )


def exact_modularity(G: WeightedGraph, C, round_digits: int = 16):
    """Modularity of clustering ``C`` on weighted graph ``G``:
    Q = Σ_c (internal_c·m − degree_c²) / m², rounded to ``round_digits``
    (reference ``louvain_communities/impl.py:340``).  ``G.WE`` is taken as a
    directed edge list; for an undirected graph list each edge once per
    direction (or accept the reference's same halving convention)."""
    clusters = C.groupby(id=C.c).reduce()

    by_u = G.WE.with_columns(c=C.ix(G.WE.u).c)
    cluster_degrees = clusters.with_columns(degree=0.0).update_rows(
        by_u.groupby(id=by_u.c).reduce(degree=reducers.sum(by_u.weight))
    )

    tagged = G.WE.with_columns(cu=C.ix(G.WE.u).c, cv=C.ix(G.WE.v).c)
    internal_edges = tagged.filter(tagged.cu == tagged.cv)
    cluster_internal = clusters.with_columns(internal=0.0).update_rows(
        internal_edges.groupby(id=internal_edges.cu).reduce(
            internal=reducers.sum(internal_edges.weight)
        )
    )

    total_weight = G.WE.reduce(m=reducers.sum(G.WE.weight))

    from pathway_tpu_torch.internals import expression as expr_mod

    score = clusters.select(
        modularity=expr_mod.apply_with_type(
            lambda internal, degree, total: (internal * total - degree * degree)
            / (total * total),
            float,
            cluster_internal.restrict(clusters).internal,
            cluster_degrees.restrict(clusters).degree,
            total_weight.ix_ref().m,
        )
    )
    return score.reduce(
        modularity=expr_mod.apply_with_type(
            lambda s: round(s, round_digits), float, reducers.sum(score.modularity)
        )
    )
