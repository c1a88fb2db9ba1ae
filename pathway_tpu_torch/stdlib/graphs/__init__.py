"""Graph algorithms over ``pw.iterate`` (reference ``stdlib/graphs/``):
bellman_ford, pagerank, louvain communities; Graph/WeightedGraph
containers with cluster contraction and exact modularity."""

from __future__ import annotations

import math

import pathway_tpu_torch.internals.iterate as iterate_mod
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.stdlib.graphs.common import (
    Cluster,
    Clustering,
    Edge,
    Vertex,
    Weight,
)
from pathway_tpu_torch.stdlib.graphs.graph import Graph, WeightedGraph, exact_modularity
from pathway_tpu_torch.stdlib.graphs.louvain import (
    louvain_communities_fixed_iterations,
    louvain_level_fixed_iterations,
)


def bellman_ford(vertices, edges):
    """Single-source shortest paths (reference
    ``stdlib/graphs/bellman_ford/impl.py:42``).  ``vertices`` carries either
    ``is_source`` (bool, reference API) or a prebuilt ``dist_from_source`` /
    ``dist_from_start`` float column; ``edges`` has u, v, dist columns.
    Returns a table with ``dist_from_source`` on the vertex universe."""
    names = vertices.column_names()
    if "is_source" in names:
        vertices = vertices.select(
            dist_from_source=expr_mod.if_else(vertices.is_source, 0.0, math.inf)
        )
    elif "dist_from_start" in names:
        vertices = vertices.select(dist_from_source=vertices.dist_from_start)
    else:
        vertices = vertices.select(dist_from_source=vertices.dist_from_source)

    def step(vertices, edges):
        # min candidate distance per target vertex
        j = edges.join(vertices, edges.u == vertices.id).select(
            target=edges.v, cand=vertices.dist_from_source + edges.dist
        )
        best = j.groupby(j.target).reduce(
            j.target, best=reducers.min(j.cand)
        )
        joined = vertices.join_left(best, vertices.id == best.target, id=vertices.id).select(
            old=vertices.dist_from_source,
            cand=best.best,
        )
        new_vertices = joined.select(
            dist_from_source=expr_mod.if_else(
                expr_mod.coalesce(joined.cand, math.inf) < joined.old,
                expr_mod.coalesce(joined.cand, math.inf),
                joined.old,
            )
        )
        return dict(vertices=new_vertices, edges=edges)

    return iterate_mod.iterate(
        lambda vertices, edges: step(vertices, edges),
        vertices=vertices,
        edges=edges,
    ).vertices


def pagerank(edges, steps: int = 50, damping: float = 0.85):
    """PageRank over an edge table with ``u``/``v`` endpoint columns —
    iterative power method. Returns a table keyed by vertex (id =
    ``pointer_from(v)``) with columns ``v`` (the vertex value) and ``rank``.
    """
    from pathway_tpu_torch.internals import thisclass

    vertices = (
        edges.select(v=edges.u)
        .concat_reindex(edges.select(v=edges.v))
        .groupby(thisclass.this.v)
        .reduce(thisclass.this.v)
        .with_id_from(thisclass.this.v)
    )
    degrees = edges.groupby(edges.u).reduce(
        edges.u, degree=reducers.count()
    )
    ranks = vertices.select(vertices.v, rank=1.0)

    for _ in range(steps):
        with_rank = edges.join(ranks, edges.u == ranks.v).select(
            u=edges.u, target=edges.v, rank=ranks.rank
        )
        contribs = with_rank.join(degrees, with_rank.u == degrees.u).select(
            target=with_rank.target,
            contrib=with_rank.rank / degrees.degree,
        )
        incoming = contribs.groupby(contribs.target).reduce(
            contribs.target, total=reducers.sum(contribs.contrib)
        )
        joined = ranks.join_left(
            incoming, ranks.v == incoming.target, id=ranks.id
        ).select(ranks.v, total=incoming.total)
        ranks = joined.select(
            joined.v,
            rank=(1 - damping) + damping * expr_mod.coalesce(joined.total, 0.0),
        )
    return ranks


def _louvain_partition(adj: dict, resolution: float, levels: int) -> dict:
    """Greedy-modularity Louvain on an undirected weighted adjacency map
    {node: {nbr: w}}. Deterministic (sorted node order). Returns
    {node: community_label}."""
    mapping = {n: n for n in adj}  # original node -> current supernode

    for _ in range(levels):
        nodes = sorted(adj, key=repr)
        m2 = sum(sum(nb.values()) for nb in adj.values())  # 2m (both dirs)
        if m2 == 0:
            break
        degree = {n: sum(adj[n].values()) for n in nodes}
        comm = {n: n for n in nodes}
        comm_degree = dict(degree)

        moved = True
        passes = 0
        while moved and passes < 10:
            moved = False
            passes += 1
            for n in nodes:
                cn = comm[n]
                comm_degree[cn] -= degree[n]
                # weight from n into each neighbouring community
                links: dict = {}
                for nbr, w in adj[n].items():
                    if nbr == n:
                        continue
                    links[comm[nbr]] = links.get(comm[nbr], 0.0) + w
                best_c, best_gain = cn, 0.0
                base = links.get(cn, 0.0) - resolution * comm_degree[cn] * degree[n] / m2
                for c, w_in in sorted(links.items(), key=lambda kv: repr(kv[0])):
                    gain = w_in - resolution * comm_degree[c] * degree[n] / m2
                    if gain > base and gain > best_gain:
                        best_gain, best_c = gain, c
                comm[n] = best_c
                comm_degree[best_c] += degree[n]
                if best_c != cn:
                    moved = True

        # relabel communities by their smallest member for determinism
        members: dict = {}
        for n, c in comm.items():
            members.setdefault(c, []).append(n)
        label = {c: min(ns, key=repr) for c, ns in members.items()}
        comm = {n: label[c] for n, c in comm.items()}
        mapping = {orig: comm[sup] for orig, sup in mapping.items()}
        if len(set(comm.values())) == len(adj):
            break  # no merge happened: converged

        # aggregate: communities become supernodes
        new_adj: dict = {}
        for n, nbrs in adj.items():
            cn = comm[n]
            row = new_adj.setdefault(cn, {})
            for nbr, w in nbrs.items():
                row[comm[nbr]] = row.get(comm[nbr], 0.0) + w
        adj = new_adj

    return mapping


def louvain_communities(edges, weight=None, resolution: float = 1.0,
                        levels: int = 3):
    """Community detection by greedy modularity (Louvain method) over an
    edge table with ``u``/``v`` columns and optional ``weight``.

    Reference capability: ``stdlib/graphs/louvain_communities`` (dataflow
    implementation over WeightedGraph). Here the whole graph is decoded by a
    stateful whole-table reducer on every consolidation — incremental in the
    replay sense (retractions re-cluster) — and flattened back into a table
    keyed by vertex with columns ``v`` (vertex) and ``community`` (the
    smallest member of the vertex's community, a deterministic label).
    """
    from pathway_tpu_torch.internals import thisclass

    w_expr = weight if weight is not None else expr_mod.ColumnConstExpression(1.0)
    packed = edges.select(u=edges.u, v=edges.v, w=w_expr)

    def cluster(_state, rows):
        adj: dict = {}
        # the engine pre-filters to positive net counts (StatefulAcc.compute)
        for (u, v, w), count in rows:
            ww = float(w) * count
            adj.setdefault(u, {})[v] = adj.get(u, {}).get(v, 0.0) + ww
            adj.setdefault(v, {})[u] = adj.get(v, {}).get(u, 0.0) + ww
        if not adj:
            return ()
        mapping = _louvain_partition(adj, resolution, levels)
        return tuple(sorted(mapping.items(), key=lambda kv: repr(kv[0])))

    assign_reducer = reducers.stateful_many(cluster)
    assignments = packed.groupby().reduce(
        pairs=assign_reducer(packed.u, packed.v, packed.w)
    )
    flat = assignments.flatten(assignments.pairs)
    return flat.select(
        v=flat.pairs.get(0), community=flat.pairs.get(1)
    ).with_id_from(thisclass.this.v)
