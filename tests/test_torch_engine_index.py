"""The KNN index seam of the port's engine (``DataIndex`` over
``BruteForceKnn``, ``ExternalIndexNode`` over ``ops/knn.py``) held against
the JAX package: the BruteForceKnn cases of ``tests/test_indexing.py``
(:37-:171) run through both packages on the same seeded vectors, and the
replies (row ids, matched values) must be equal. The port's index runs on
the CPU only when asked (``device="cpu"``)."""

import numpy as np
import pytest

from tests.torch_engine import PACKAGES, PW, final_state


def _knn(pkg, pw, column, *args, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return pw.indexing.BruteForceKnn(column, *args, **kw)


def _vec_tables(pw, dim=8, n=6, nq=3, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float64)
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(doc=str, vec=np.ndarray),
        [(f"d{i}", vecs[i]) for i in range(n)])
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(qvec=np.ndarray),
        [(vecs[i] + 0.001,) for i in range(nq)])
    return docs, queries, vecs


def _query(pkg, matches=1, metric="cos", n=6, nq=3, as_of_now=True):
    pw = PW[pkg]
    pw.clear_graph()
    docs, queries, vecs = _vec_tables(pw, n=n, nq=nq)
    index = pw.indexing.DataIndex(docs, _knn(pkg, pw, docs.vec, dimensions=8, metric=metric))
    fn = index.query_as_of_now if as_of_now else index.query
    res = fn(queries.qvec, number_of_matches=matches)
    return final_state(pkg, res), vecs


def _both(**kw):
    out = {pkg: _query(pkg, **kw) for pkg in PACKAGES}
    assert out["torch"][0] == out["jax"][0]
    return out["torch"]


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_knn_exact_top1(metric):
    (rows, cols), _ = _both(metric=metric)
    di = cols.index("doc")
    assert sorted(row[di][0] for row in rows.values()) == ["d0", "d1", "d2"]


@pytest.mark.parametrize("as_of_now", [True, False])
def test_knn_number_of_matches(as_of_now):
    (rows, cols), _ = _both(matches=5, as_of_now=as_of_now)
    di = cols.index("doc")
    assert all(len(row[di]) == 5 for row in rows.values())


def test_knn_matches_numpy_reference():
    (rows, cols), vecs = _both(matches=4, n=32, nq=3)
    di = cols.index("doc")
    nv = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    for i in range(3):
        q = vecs[i] + 0.001
        scores = nv @ (q / np.linalg.norm(q))
        expect = {f"d{j}" for j in np.argsort(-scores)[:4]}
        got = [row[di] for row in rows.values() if row[di][:1] == (f"d{i}",)]
        assert got and set(got[0]) == expect


def test_knn_with_distances():
    (rows, cols), _ = _both(matches=3)
    assert "_pw_dist" not in cols
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        docs, queries, _ = _vec_tables(pw)
        index = pw.indexing.DataIndex(docs, _knn(pkg, pw, docs.vec, dimensions=8))
        res = index.query_as_of_now(queries.qvec, number_of_matches=3, with_distances=True)
        out[pkg] = final_state(pkg, res)
    (t_rows, t_cols), (j_rows, _j_cols) = out["torch"], out["jax"]
    assert t_rows.keys() == j_rows.keys()
    di, dd = t_cols.index("doc"), t_cols.index("_pw_dist")
    for k in t_rows:
        assert t_rows[k][di] == j_rows[k][di]
        # bf16 corpora on both sides: distances agree to bf16 rounding
        np.testing.assert_allclose(t_rows[k][dd], j_rows[k][dd], atol=2e-2)


def test_metadata_filter():
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(doc=str, vec=np.ndarray, meta=pw.Json),
            [("a", np.array([1.0, 0.0]), pw.Json({"owner": "alice"})),
             ("b", np.array([0.9, 0.1]), pw.Json({"owner": "bob"}))])
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(qvec=np.ndarray, flt=str),
            [(np.array([1.0, 0.0]), "owner == 'bob'")])
        index = pw.indexing.DataIndex(docs, _knn(pkg, pw, docs.vec, docs.meta, dimensions=2))
        res = index.query_as_of_now(queries.qvec, number_of_matches=2,
                                    metadata_filter=queries.flt)
        rows, cols = final_state(pkg, res)
        (row,) = rows.values()
        assert row[cols.index("doc")] == ("b",)
        out[pkg] = rows
    assert out["torch"] == out["jax"]


def test_knn_index_streaming_adds():
    """Docs arriving after a query do not re-answer it (as of now)."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        docs = pw.debug.table_from_markdown("""
            doc | x   | y   | __time__
            a   | 1.0 | 0.0 | 2
            b   | 0.0 | 1.0 | 6
            """)
        docs = docs.select(docs.doc, vec=pw.apply_with_type(
            lambda x, y: np.array([x, y]), np.ndarray, docs.x, docs.y))
        queries = pw.debug.table_from_markdown("""
            qx  | qy  | __time__
            0.1 | 0.9 | 4
            """)
        queries = queries.select(qvec=pw.apply_with_type(
            lambda x, y: np.array([x, y]), np.ndarray, queries.qx, queries.qy))
        index = pw.indexing.DataIndex(docs, _knn(pkg, pw, docs.vec, dimensions=2))
        rows, cols = final_state(pkg, index.query_as_of_now(queries.qvec, number_of_matches=1))
        (row,) = rows.values()
        assert row[cols.index("doc")] == ("a",)
        out[pkg] = rows
    assert out["torch"] == out["jax"]


def test_factory_builds_the_same_index():
    pw = PW["torch"]
    pw.clear_graph()
    docs, queries, _ = _vec_tables(pw)
    factory = pw.indexing.BruteForceKnnFactory(dimensions=8, reserved_space=64,
                                               device="cpu")
    index = factory.build_index(docs.vec, docs)
    rows, cols = final_state("torch", index.query_as_of_now(queries.qvec,
                                                            number_of_matches=1))
    di = cols.index("doc")
    assert sorted(row[di][0] for row in rows.values()) == ["d0", "d1", "d2"]
    with pytest.raises(ValueError, match="dimensions"):
        pw.indexing.BruteForceKnnFactory()
