"""Louvain community detection as incremental dataflow
(reference ``stdlib/graphs/louvain_communities/impl.py``).

The reference runs per-iteration parallel move proposals with an
independent-set filter.  This implementation uses synchronous parallel
moves (every vertex adopts its best neighboring cluster each iteration):
simpler, fully incremental, and bounded by the fixed iteration count — on
oscillation-free graphs both converge to the same clustering.  The exact
hierarchical driver contracts between levels via ``WeightedGraph``.

The host-side batch variant (faster for static graphs) remains
``stdlib.graphs.louvain_communities``.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.stdlib.graphs.graph import WeightedGraph


def _one_step(G: WeightedGraph, clustering):
    """One synchronous move round: each vertex joins the neighboring cluster
    maximizing the modularity gain  w(u→c) − deg(u)·deg(c)/(2m)."""
    WE = G.WE
    tagged = WE.select(
        u=WE.u,
        weight=WE.weight,
        cu=clustering.ix(WE.u).c,
        cv=clustering.ix(WE.v).c,
    )

    # weight from vertex u to each adjacent cluster c
    to_cluster = tagged.groupby(tagged.u, tagged.cv).reduce(
        tagged.u,
        c=tagged.cv,
        w=reducers.sum(tagged.weight),
    )

    deg_u = tagged.groupby(tagged.u).reduce(tagged.u, deg=reducers.sum(tagged.weight))
    deg_c = tagged.groupby(tagged.cv).reduce(
        c=tagged.cv, deg=reducers.sum(tagged.weight)
    )
    total = WE.reduce(m=reducers.sum(WE.weight))

    cand = to_cluster.select(
        to_cluster.u,
        to_cluster.c,
        gain=to_cluster.w
        - deg_u.ix_ref(to_cluster.u).deg
        * deg_c.ix_ref(to_cluster.c).deg
        / total.ix_ref().m,
    )
    best = cand.groupby(cand.u).reduce(
        cand.u,
        ptr=reducers.argmax(cand.gain),
        gain=reducers.max(cand.gain),
    )
    best = best.select(
        best.u,
        best.gain,
        c=cand.ix(best.ptr).c,
        cur=clustering.ix(best.u).c,
    )
    # symmetry-break synchronous moves: labels flow monotonically toward
    # smaller cluster ids, which kills the label-rotation cycles a fully
    # parallel update would produce (cf. min-label propagation)
    moves_tbl = best.filter(
        (best.gain > 0.0)
        & expr_mod.apply_with_type(
            lambda new, cur: new is not None
            and cur is not None
            and new.value < cur.value,
            bool,
            best.c,
            best.cur,
        )
    )
    rekeyed = moves_tbl.with_id(moves_tbl.u)
    moves = rekeyed.select(c=rekeyed.c)
    return clustering.update_rows(moves)


def louvain_level_fixed_iterations(G: WeightedGraph, number_of_iterations: int):
    """Run ``number_of_iterations`` synchronous move rounds from singleton
    clusters; returns a Clustering table (vertex id → cluster pointer ``c``).
    Reference ``impl.py:252`` (``_louvain_level_fixed_iterations``)."""
    clustering = G.V.select(c=G.V.id)
    for _ in range(number_of_iterations):
        clustering = _one_step(G, clustering)
    return clustering


class louvain_communities_fixed_iterations:
    """Hierarchical Louvain with a fixed iteration budget per level
    (reference ``impl.py:282``).  After construction:

    - ``clustering_levels`` — list of per-level Clustering tables (finest
      first, each mapping that level's vertices to the next level's),
    - ``hierarchical_clustering`` — composed mapping from original vertices
      to top-level clusters,
    - ``G`` — the original graph; ``levels`` — the level count.
    """

    def __init__(self, G: WeightedGraph, iterations: int = 10, levels: int = 1):
        self.G = G
        self.levels = levels
        self.clustering_levels = []
        current = G
        composed = None
        for _ in range(levels):
            clustering = louvain_level_fixed_iterations(current, iterations)
            self.clustering_levels.append(clustering)
            if composed is None:
                composed = clustering
            else:
                composed = composed.select(c=clustering.ix(composed.c).c)
            current = current.contracted_to_weighted_simple_graph(
                clustering, weight=reducers.sum(current.WE.weight)
            )
        self.hierarchical_clustering = composed
