"""The port's ``pw.graphs`` held against the JAX package's: the cases of
``tests/test_graphs_parity.py`` (the ``Graph`` / ``WeightedGraph``
containers, contraction, exact modularity, the dataflow Louvain levels and
``bellman_ford`` over ``pw.iterate``) and the ``pagerank`` /
``louvain_communities`` cases of ``tests/test_stdlib_breadth.py`` and
``tests/test_stdlib_matrix.py`` go through both packages; final tables
(row ids and values) and update streams must be equal, and the port's rows
must show what the JAX tests assert."""

import importlib

import pytest

from tests.torch_engine import PACKAGES, PW, final_state, update_stream


def _g(pw):
    return importlib.import_module(f"{pw.__name__}.stdlib.graphs")


def _two_triangles(pw):
    verts = pw.debug.table_from_markdown("""
        name
        a0
        a1
        a2
        b3
        b4
        b5
        """)
    pairs = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5), (2, 3)]
    names = ["a0", "a1", "a2", "b3", "b4", "b5"]
    rows = []
    for u, v in pairs:
        rows.append((names[u], names[v], 1.0))
        rows.append((names[v], names[u], 1.0))
    raw = pw.debug.table_from_rows(schema=pw.schema_from_types(un=str, vn=str, weight=float),
                                   rows=rows)
    edges = raw.select(u=verts.pointer_from(raw.un), v=verts.pointer_from(raw.vn),
                       weight=raw.weight)
    return verts.with_id_from(verts.name), edges


def _weighted(pw):
    verts, edges = _two_triangles(pw)
    return _g(pw).WeightedGraph.from_vertices_and_weighted_edges(verts, edges)


def _louvain_level(pw):
    return _g(pw).louvain_level_fixed_iterations(_weighted(pw), 5)


def _modularity(pw):
    G = _weighted(pw)
    return _g(pw).exact_modularity(G, _g(pw).louvain_level_fixed_iterations(G, 5))


def _hierarchical(pw, which):
    res = _g(pw).louvain_communities_fixed_iterations(_weighted(pw), iterations=4, levels=2)
    if which == "levels":
        return res.clustering_levels[1]
    return res.hierarchical_clustering


def _contracted(pw, which):
    g = _g(pw)
    G = _weighted(pw)
    contracted = G.contracted_to_weighted_simple_graph(
        g.louvain_level_fixed_iterations(G, 5), weight=pw.reducers.sum(G.WE.weight))
    if which == "V":
        return contracted.V
    if which == "WE":
        return contracted.WE
    return contracted.without_self_loops().WE


def _bellman_ford(pw):
    verts = pw.debug.table_from_markdown("""
        name | is_source
        s    | True
        a    | False
        b    | False
        c    | False
        """).with_id_from(pw.this.name)
    raw = pw.debug.table_from_rows(
        schema=pw.schema_from_types(un=str, vn=str, dist=float),
        rows=[("s", "a", 1.0), ("a", "b", 2.0), ("s", "b", 5.0), ("b", "c", 1.0)])
    edges = raw.select(u=verts.pointer_from(raw.un), v=verts.pointer_from(raw.vn),
                       dist=raw.dist)
    return _g(pw).bellman_ford(verts, edges)


def _pagerank(pw, steps=50):
    edges = pw.debug.table_from_markdown("""
        u | v
        a | c
        b | c
        d | c
        c | a
        """)
    return _g(pw).pagerank(edges, steps=steps)


def _pagerank_symmetric(pw):
    edges = pw.debug.table_from_markdown("""
        u | v
        a | b
        b | a
        """)
    return _g(pw).pagerank(edges, steps=20)


def _louvain_cliques(pw):
    rows = []
    for group in (["a1", "a2", "a3", "a4"], ["b1", "b2", "b3", "b4"]):
        for i in range(len(group)):
            for j in range(i + 1, len(group)):
                rows.append(f"{group[i]} | {group[j]}")
    rows.append("a1 | b1")  # bridge
    edges = pw.debug.table_from_markdown("u | v\n" + "\n".join(rows))
    return _g(pw).louvain_communities(edges)


PROGRAMS = {
    "louvain_level": _louvain_level,
    "modularity": _modularity,
    "hierarchical": lambda pw: _hierarchical(pw, "composed"),
    "hierarchical_level2": lambda pw: _hierarchical(pw, "levels"),
    "contracted_V": lambda pw: _contracted(pw, "V"),
    "contracted_WE": lambda pw: _contracted(pw, "WE"),
    "contracted_no_loops": lambda pw: _contracted(pw, "no_loops"),
    "bellman_ford": _bellman_ford,
    "pagerank": _pagerank,
    "pagerank_symmetric": _pagerank_symmetric,
    "louvain_cliques": _louvain_cliques,
}


def _both(build):
    out = []
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        final = final_state(pkg, build(pw))
        pw.clear_graph()
        stream = update_stream(pkg, build(pw))
        pw.clear_graph()
        out.append((final, stream))
    (jf, js), (tf, ts) = out
    assert tf == jf
    assert ts == js
    return tf


def _col(final, name):
    rows, cols = final
    return {k: r[cols.index(name)] for k, r in rows.items()}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_equals_jax(name):
    final = _both(PROGRAMS[name])
    rows, cols = final
    if name == "louvain_level":
        assert len(rows) == 6 and len(set(_col(final, "c").values())) == 2
    elif name == "modularity":
        (q,) = _col(final, "modularity").values()
        assert q == pytest.approx(5 / 14, abs=1e-9)
    elif name == "hierarchical":
        assert len(rows) == 6 and len(set(_col(final, "c").values())) <= 2
    elif name == "contracted_V":
        assert len(rows) == 2
    elif name == "contracted_WE":
        w = {(r[cols.index("u")], r[cols.index("v")]): r[cols.index("weight")]
             for r in rows.values()}
        assert sorted(x for (u, v), x in w.items() if u == v) == [6.0, 6.0]
        assert [x for (u, v), x in w.items() if u != v] == [1.0, 1.0]
    elif name == "contracted_no_loops":
        assert len(rows) == 2
    elif name == "bellman_ford":
        assert sorted(_col(final, "dist_from_source").values()) == [0.0, 1.0, 3.0, 4.0]
    elif name == "pagerank":
        ranks = {r[cols.index("v")]: r[cols.index("rank")] for r in rows.values()}
        assert max(ranks, key=ranks.get) == "c"
        assert ranks["a"] > ranks["b"] == ranks["d"]
    elif name == "pagerank_symmetric":
        ranks = list(_col(final, "rank").values())
        assert len(ranks) == 2 and abs(ranks[0] - ranks[1]) <= 1
    elif name == "louvain_cliques":
        comm = {r[cols.index("v")]: r[cols.index("community")] for r in rows.values()}
        a = {comm[f"a{i}"] for i in range(1, 5)}
        b = {comm[f"b{i}"] for i in range(1, 5)}
        assert len(a) == 1 and len(b) == 1 and a != b


def test_hierarchical_keeps_its_levels():
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        res = _g(pw).louvain_communities_fixed_iterations(_weighted(pw), iterations=4,
                                                           levels=2)
        assert len(res.clustering_levels) == 2 and res.levels == 2
        pw.clear_graph()


def test_public_names_equal_jax():
    import pathway_tpu as J
    import pathway_tpu_torch as T

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")} - {"annotations"}

    assert public(T.graphs) == public(J.graphs)
