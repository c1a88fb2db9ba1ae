"""The rest of the port's ``pw.indexing`` held against the JAX package:
the IVF, uSearch (HNSW), LSH, BM25 and hybrid inner indexes and their
factories, the default document indexes and the legacy ``KNNIndex``, each
through ``DataIndex`` on the same seeded vectors (the cases of
``tests/test_indexing.py`` :87, :111, :171, :269, :513 and
``tests/test_indexing_matrix.py`` :13-:109), the mesh routing of the
factories (``tests/test_mesh_serving.py`` :303, on 4 virtual CPU
positions), and BASELINE configs 1 and 2 as users write them, through
``pw.run()`` with a 2-layer, 64-wide encoder (both packages' vectors and
replies within 1e-4).

Bars: BM25 scores exactly equal (the same float arithmetic); HNSW replies
equal key for key and score for score (one algorithm, one RNG order);
IVF over f32 cells equal keys but at near-ties (1e-5), bf16 cells by the
JAX tests' recall bars; the exact indexes' replies equal. The port's
indexes run on the CPU only when asked (``device="cpu"``). Every wait of a
live run is bounded."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_engine import PACKAGES, PW, final_state
from tests.torch_rest import LiveRun, post_json

LLM_TIMEOUT = 30.0
TIE = 1e-5


def _cpu(pkg, **kw):
    return {**kw, "device": "cpu"} if pkg == "torch" else kw


def _vec_tables(pw, dim=8, n=16, nq=3, seed=42):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, dim))
    docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str, vec=np.ndarray),
                                    [(f"d{i}", vecs[i]) for i in range(n)])
    queries = pw.debug.table_from_rows(pw.schema_from_types(qid=int, qvec=np.ndarray),
                                       [(i, vecs[i] + 0.001) for i in range(nq)])
    return docs, queries, vecs


def _per_pkg(build):
    """{pkg: (final state, columns)} of ``build(pkg, pw)``'s table."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        out[pkg] = final_state(pkg, build(pkg, pw))
    return out


def _both(build):
    out = _per_pkg(build)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _docs_of(state):
    rows, cols = state
    di = cols.index("doc")
    return {k: row[di] for k, row in rows.items()}


# --------------------------------------------------------------- BM25
def _bm25_corpus():
    rng = np.random.default_rng(3)
    words = ["stream", "engine", "tensor", "index", "query", "alpha", "beta", "chip",
             "rare", "the", "cat", "dog"]
    return [" ".join(rng.choice(words, int(rng.integers(1, 12)))) for _ in range(60)]


def test_bm25_scores_exactly_equal_jax():
    from pathway_tpu.stdlib.indexing.bm25 import Bm25Index as J
    from pathway_tpu_torch.stdlib.indexing.bm25 import Bm25Index as T

    docs = _bm25_corpus()
    queries = ["stream engine", "rare", "the cat", "tensor index query", "missing", ""]
    out = {}
    for name, cls in (("torch", T), ("jax", J)):
        idx = cls()
        idx.add([f"d{i}" for i in range(len(docs))], docs)
        idx.add(["list", "arr"], [["stream", 3], np.array(["chip", "beta"])])
        first = idx.search(queries, k=7)
        idx.remove([f"d{i}" for i in range(0, 60, 3)] + ["absent"])
        out[name] = (first, idx.search(queries, k=7), len(idx), dict(idx.df))
    assert out["torch"] == out["jax"]  # scores equal to the last bit
    assert out["torch"][2] == 42 and out["torch"][0][4] == [] and out["torch"][0][0]


def test_bm25_ranks_term_frequency():
    from pathway_tpu_torch.stdlib.indexing.bm25 import Bm25Index

    idx = Bm25Index()
    idx.add(["d1", "d2", "d3"], ["stream processing engine", "stream stream stream everywhere",
                                 "unrelated document about cats"])
    keys = [k for k, _ in idx.search(["stream"], k=2)[0]]
    assert keys[0] == "d2" and "d3" not in keys


def test_bm25_idf_downweights_common_terms():
    from pathway_tpu_torch.stdlib.indexing.bm25 import Bm25Index

    idx = Bm25Index()
    idx.add(["d1", "d2", "d3"], ["the cat", "the dog", "the bird rare"])
    assert [k for k, _ in idx.search(["rare the"], k=3)[0]][0] == "d3"


def test_bm25_remove_updates_results():
    from pathway_tpu_torch.stdlib.indexing.bm25 import Bm25Index

    idx = Bm25Index()
    idx.add(["d1", "d2"], ["alpha beta", "alpha gamma"])
    idx.remove(["d1"])
    assert [k for k, _ in idx.search(["alpha"], k=5)[0]] == ["d2"] and len(idx) == 1


def test_bm25_data_index():
    def build(pkg, pw):
        docs = pw.debug.table_from_rows(pw.schema_from_types(text=str), [
            ("the quick brown fox",), ("lazy dogs sleep all day",),
            ("quick quick foxes everywhere",)])
        q = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("quick fox",)])
        index = pw.indexing.DataIndex(docs, pw.indexing.TantivyBM25(docs.text))
        return index.query_as_of_now(q.q, number_of_matches=2, with_distances=True)

    rows, cols = _both(build)
    (row,) = rows.values()
    assert len(row[cols.index("text")]) == 2
    assert all("quick" in t for t in row[cols.index("text")])


def test_tantivy_bm25_factory_data_index_pipeline():
    def build(pkg, pw):
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [
            ("apple pie recipe",), ("car engine manual",)])
        queries = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("engine",)])
        index = pw.indexing.TantivyBM25Factory().build_index(docs.doc, docs)
        return index.query_as_of_now(queries.q, number_of_matches=1)

    rows, cols = _both(build)
    (row,) = rows.values()
    assert row[cols.index("doc")] == ("car engine manual",)


# ------------------------------------------------------------- hybrid
def _hash_embed(pw):
    """A seeded vector a text: no two texts tie (the port orders a
    sub-index's ties by row before fusing, JAX by arrival)."""

    @pw.udf
    def embed(text: str) -> np.ndarray:
        seed = sum(ord(c) * (i + 1) for i, c in enumerate(text))
        v = np.random.default_rng(seed).normal(size=8)
        return v / np.linalg.norm(v)

    return embed


@pytest.mark.parametrize("k_matches", [1, 3])
def test_hybrid_rrf_fuses_vector_and_text(k_matches):
    def build(pkg, pw):
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [
            (d,) for d in ("alpha text", "beta text", "gamma text", "beta words", "delta")])
        vec_idx = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(
            docs.doc, **_cpu(pkg, dimensions=8, embedder=_hash_embed(pw))))
        txt_idx = pw.indexing.DataIndex(docs, pw.indexing.TantivyBM25(docs.doc))
        hybrid = pw.indexing.HybridIndexDataIndex([vec_idx, txt_idx])
        queries = pw.debug.table_from_rows(pw.schema_from_types(qt=str),
                                           [("beta text",), ("delta",)])
        return hybrid.query_as_of_now(queries.qt, number_of_matches=k_matches)

    rows, cols = _both(build)
    got = sorted(row[cols.index("doc")] for row in rows.values())
    assert all(len(g) == k_matches for g in got)
    assert ("beta text" in {g[0] for g in got}) and ("delta" in {g[0] for g in got})


def test_hybrid_orders_sub_index_ties_by_row():
    """Equal sub-index scores (the three docs of one BM25 term) fuse in
    one order whatever the query row's id: their rows' ``repr`` order."""
    import pathway_tpu_torch as pw

    replies = []
    for qid in range(4):
        pw.clear_graph()
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [
            (d,) for d in ("cat one", "cat two", "cat six", "dog")])
        hybrid = pw.indexing.HybridIndexFactory([pw.indexing.TantivyBM25Factory()]).build_index(
            docs.doc, docs)
        queries = pw.debug.table_from_rows(pw.schema_from_types(q=str, n=int), [("cat", qid)])
        _, got = pw.debug.table_to_dicts(hybrid.query_as_of_now(queries.q, number_of_matches=3))
        replies.append(list(got["doc"].values()))
    assert replies == [[("cat one", "cat six", "cat two")]] * 4


def test_hybrid_factory_column_limit_and_distances_equal_host_rrf():
    """Beyond JAX's facade (which ``DocumentStore`` cannot use): a column
    ``number_of_matches`` and ``_pw_dist``, equal to an RRF computed on the
    host from the two sub-indexes' own replies at twice the matches."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing.hybrid_index import canonical_ranking, rrf_fuse

    def run(factory, mult=1):
        # one query table for every run: a row's id orders the ties
        pw.clear_graph()
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [
            (d,) for d in _bm25_corpus()[:30]])
        queries = pw.debug.table_from_rows(pw.schema_from_types(q=str, k=int), qs)
        index = factory.build_index(docs.doc, docs)
        res = index.query_as_of_now(queries.q, number_of_matches=queries.k * mult,
                                    with_distances=True)
        res = res.select(res.doc, res._pw_dist, q=queries.restrict(res).q)
        _, got = pw.debug.table_to_dicts(res)
        return {got["q"][k]: (got["doc"][k], got["_pw_dist"][k]) for k in got["q"]}

    qs = [("stream engine", 3), ("rare cat", 5), ("alpha", 2)]
    knn = pw.indexing.BruteForceKnnFactory(dimensions=8, embedder=_hash_embed(pw),
                                           device="cpu")
    bm25 = pw.indexing.TantivyBM25Factory()
    hybrid = run(pw.indexing.HybridIndexFactory([knn, bm25]))
    subs = [run(f, mult=2) for f in (knn, bm25)]
    for q, k in qs:
        want = rrf_fuse([canonical_ranking([(d,) for d in sub[q][0]], sub[q][1])
                         for sub in subs], k)
        doc_of = {repr((d,)): d for sub in subs for d in sub[q][0]}
        assert hybrid[q][0] == tuple(doc_of[key] for key, _s in want)
        assert hybrid[q][1] == tuple(-s for _d, s in want)
        assert len(hybrid[q][0]) == k


# ------------------------------------------------- the KNN factories
def test_metadata_filter():
    def build(pkg, pw):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(doc=str, vec=np.ndarray, meta=pw.Json),
            [("a", np.array([1.0, 0.0]), pw.Json({"owner": "alice"})),
             ("b", np.array([0.9, 0.1]), pw.Json({"owner": "bob"}))])
        queries = pw.debug.table_from_rows(pw.schema_from_types(qvec=np.ndarray, flt=str),
                                           [(np.array([1.0, 0.0]), "owner == 'bob'")])
        inner = pw.indexing.BruteForceKnn(docs.vec, docs.meta, **_cpu(pkg, dimensions=2))
        return pw.indexing.DataIndex(docs, inner).query_as_of_now(
            queries.qvec, number_of_matches=2, metadata_filter=queries.flt)

    rows, cols = _both(build)
    (row,) = rows.values()
    assert row[cols.index("doc")] == ("b",)


def test_legacy_knnindex_api():
    from pathway_tpu.stdlib.ml import KNNIndex as J
    from pathway_tpu_torch.stdlib.ml import KNNIndex as T

    def build(pkg, pw):
        docs, queries, _ = _vec_tables(pw)
        index = T(docs.vec, docs, n_dimensions=8, device="cpu") if pkg == "torch" else J(
            docs.vec, docs, n_dimensions=8)
        return index.get_nearest_items(queries.qvec, k=2)

    docs = _docs_of(_both(build))
    assert sorted(d[0] for d in docs.values()) == ["d0", "d1", "d2"]
    assert all(len(d) == 2 for d in docs.values())


@pytest.mark.parametrize("name", ["lsh", "usearch", "ivf_f32"])
def test_knn_inner_indexes_equal_jax(name):
    """LSH (the exact l2sq path), uSearch (host HNSW: key for key, score for
    score) and IVF over f32 cells (keys but at near-ties) through
    ``DataIndex``, JAX's replies."""
    import jax.numpy as jnp

    def build(pkg, pw):
        docs, queries, _ = _vec_tables(pw, n=40, nq=6)
        ix = pw.indexing
        if name == "lsh":
            inner = ix.LshKnn(docs.vec, **_cpu(pkg, dimensions=8))
        elif name == "usearch":
            inner = ix.USearchKnn(docs.vec, dimensions=8, connectivity=4, expansion_add=16,
                                  expansion_search=16)
        else:
            inner = ix.IvfKnn(docs.vec, **_cpu(pkg, dimensions=8, n_cells=4, nprobe=2,
                                               train_after=16,
                                               dtype=torch.float32 if pkg == "torch"
                                               else jnp.float32))
        return ix.DataIndex(docs, inner).query_as_of_now(
            queries.qvec, number_of_matches=5, with_distances=True)

    out = _per_pkg(build)
    (trows, tcols), (jrows, jcols) = out["torch"], out["jax"]
    assert tcols == jcols and trows.keys() == jrows.keys()
    di, si = tcols.index("doc"), tcols.index("_pw_dist")
    for key in trows:
        t, j = trows[key], jrows[key]
        np.testing.assert_allclose(t[si], j[si], rtol=TIE, atol=TIE)
        if name == "ivf_f32":
            # near-ties may swap places; a hit's score decides its place
            for a, b, da, db in zip(t[di], j[di], t[si], j[si]):
                assert a == b or abs(da - db) <= TIE
        else:
            assert t == j
    firsts = sorted(row[di][0] for row in trows.values())
    assert firsts == [f"d{i}" for i in range(6)]  # each query finds its doc


def test_ivf_knn_in_dataflow_bf16_recall():
    def build(pkg, pw):
        docs, queries, _ = _vec_tables(pw)
        return pw.indexing.DataIndex(docs, pw.indexing.IvfKnn(
            docs.vec, **_cpu(pkg, dimensions=8, n_cells=4, nprobe=4))).query_as_of_now(
            queries.qvec, number_of_matches=2)

    out = _per_pkg(build)
    for pkg in PACKAGES:
        docs = _docs_of(out[pkg])
        assert all(len(d) == 2 for d in docs.values())
        assert sorted(d[0] for d in docs.values()) == ["d0", "d1", "d2"]
    assert out["torch"][0].keys() == out["jax"][0].keys()


def test_ivf_factory_int8_through_data_index():
    import jax.numpy as jnp

    def build(pkg, pw):
        docs, queries, _ = _vec_tables(pw)
        fac = pw.indexing.IvfKnnFactory(**_cpu(pkg, dimensions=8, n_cells=4, nprobe=4,
                                               train_after=64,
                                               dtype=torch.int8 if pkg == "torch"
                                               else jnp.int8))
        inner = fac.build_inner_index(docs.vec)
        inst = inner.make_factory().make_instance()
        assert inst.dtype == (torch.int8 if pkg == "torch" else jnp.int8)
        assert inst._scales is not None
        return pw.indexing.DataIndex(docs, inner).query_as_of_now(queries.qvec,
                                                                 number_of_matches=1)

    out = _per_pkg(build)
    for pkg in PACKAGES:
        assert sorted(d[0] for d in _docs_of(out[pkg]).values()) == ["d0", "d1", "d2"]


@pytest.mark.parametrize("fn", ["default_vector_document_index",
                                "default_brute_force_knn_document_index",
                                "default_usearch_knn_document_index",
                                "default_lsh_knn_document_index",
                                "VectorDocumentIndex"])
def test_default_vector_document_indexes_equal_jax(fn):
    def build(pkg, pw):
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [
            (d,) for d in _bm25_corpus()[:20]])
        queries = pw.debug.table_from_rows(pw.schema_from_types(q=str),
                                           [("stream engine",), ("rare cat",)])
        kw = dict(embedder=_hash_embed(pw), dimensions=8)
        if pkg == "torch" and fn != "default_usearch_knn_document_index":
            kw["device"] = "cpu"
        with pytest.warns(DeprecationWarning) if fn == "VectorDocumentIndex" else _null():
            index = getattr(pw.indexing, fn)(docs.doc, docs, **kw)
        return index.query_as_of_now(queries.q, number_of_matches=3)

    rows, cols = _both(build)
    assert all(len(r[cols.index("doc")]) == 3 for r in rows.values())


def test_default_full_text_document_index_equal_jax():
    def build(pkg, pw):
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [
            (d,) for d in _bm25_corpus()[:20]])
        queries = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("rare cat",)])
        index = pw.indexing.default_full_text_document_index(docs.doc, docs)
        return index.query_as_of_now(queries.q, number_of_matches=4, with_distances=True)

    rows, cols = _both(build)
    (row,) = rows.values()
    assert len(row[cols.index("doc")]) == 4


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------- mesh routing
def _mesh(n):
    from pathway_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device("cpu")] * n, dp=n, tp=1)


def test_ivf_factory_routes_to_sharded_index_under_mesh(monkeypatch):
    """The counterpart of JAX's mesh-flag routing: ``mesh=`` of 4 virtual
    positions routes the IVF and brute-force factories to the sharded
    IVF; none, or one position, keeps the single-device index. Self-hits
    and the backend ledger as in JAX's test, and the same top hits as
    JAX's sharded index under its flag."""
    from pathway_tpu.engine import probes as JP
    from pathway_tpu.stdlib.indexing import nearest_neighbors as JN
    from pathway_tpu_torch.engine import probes as TP
    from pathway_tpu_torch.ops.ivf import IvfFlatIndex
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
        _IvfIndexFactory,
        _KnnIndexFactory,
    )

    for mesh in (None, _mesh(1)):
        assert isinstance(_IvfIndexFactory(16, 8, 8, "cos", None, device="cpu",
                                           mesh=mesh).make_instance(), IvfFlatIndex)
        assert isinstance(_KnnIndexFactory(16, 64, "cos", device="cpu",
                                           mesh=mesh).make_instance(), BruteForceKnnIndex)
    TP.reset_retrieval_backend_stats()
    idx = _IvfIndexFactory(16, 8, 8, "cos", None, mesh=_mesh(4)).make_instance()
    assert isinstance(idx, ShardedIvfIndex) and idx.dp == 4
    knn = _KnnIndexFactory(16, 64, "cos", mesh=_mesh(4)).make_instance()
    assert isinstance(knn, ShardedIvfIndex) and knn.n_cells == knn.nprobe == 16

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(40, 16)).astype(np.float32)
    idx.add(list(range(40)), vecs)
    res = idx.search(vecs[:3], 5)
    assert [row[0][0] for row in res] == [0, 1, 2]  # self-hits
    assert TP.retrieval_backend_stats().get("sharded_ivf", 0) >= 3

    monkeypatch.setenv("PATHWAY_TPU_MESH", "1")
    jidx = JN._IvfIndexFactory(16, 8, 8, "cos", None).make_instance()
    jidx.add(list(range(40)), vecs)
    JP.reset_retrieval_backend_stats()
    jres = jidx.search(vecs[:3], 5)
    assert [row[0][0] for row in jres] == [row[0][0] for row in res]
    assert JP.retrieval_backend_stats().get("sharded_ivf", 0) >= 3


@pytest.mark.parametrize("factory", ["brute_force", "ivf"])
def test_mesh_factories_through_data_index_equal_the_unsharded_index(factory):
    """``BruteForceKnnFactory(mesh=)`` and ``IvfKnnFactory(mesh=)`` over 4
    virtual positions answer through ``DataIndex`` in ``pw.run()`` with the
    unsharded brute force's top keys (exhaustive probing) and name the
    sharded index in the backend ledger; without a mesh the replies are
    the single-device index's, byte for byte."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import probes as TP

    def run(fac):
        pw.clear_graph()
        docs, queries, _ = _vec_tables(pw, dim=16, n=200, nq=8, seed=1)
        index = fac.build_index(docs.vec, docs)
        return final_state("torch", index.query_as_of_now(queries.qvec, number_of_matches=10,
                                                          with_distances=True))

    ix = pw.indexing
    plain = run(ix.BruteForceKnnFactory(dimensions=16, device="cpu"))
    if factory == "brute_force":
        make = lambda mesh: ix.BruteForceKnnFactory(dimensions=16, device="cpu",  # noqa: E731
                                                    mesh=mesh)
    else:
        make = lambda mesh: ix.IvfKnnFactory(dimensions=16, n_cells=4, nprobe=4,  # noqa: E731
                                             device="cpu", mesh=mesh)
    TP.reset_retrieval_backend_stats()
    sharded = run(make(_mesh(4)))
    assert TP.retrieval_backend_stats().get("sharded_ivf", 0) == 8
    di, si = plain[1].index("doc"), plain[1].index("_pw_dist")
    for key, row in plain[0].items():
        got = sharded[0][key]
        for a, b, da, db in zip(got[di], row[di], got[si], row[si]):
            assert a == b or abs(da - db) <= 1e-2  # bf16 cells: near-ties swap
        np.testing.assert_allclose(got[si], row[si], rtol=0, atol=1e-2)
    if factory == "brute_force":
        assert run(make(None)) == run(make(_mesh(1))) == plain


# -------------------------------------- BASELINE configs 1 and 2 in the port
SHAPE = dict(layers=2, hidden=64, heads=4, intermediate=128, vocab_size=500, max_position=64)
ENC_TOL = 1e-4


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


@pytest.fixture(scope="module")
def models():
    import jax.numpy as jnp

    from pathway_tpu.models import MINILM_L6 as J_MINILM
    from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
    from pathway_tpu.models.tokenizer import HashTokenizer as JTok
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel as TEmbed
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import HashTokenizer as TTok
    from pathway_tpu_torch.models.transformer import MINILM_L6 as T_MINILM

    jemb = JEmbed(cfg=dataclasses.replace(J_MINILM, **SHAPE, dtype=jnp.float32),
                  max_length=32, tokenizer=JTok(vocab_size=500, max_length=32))
    temb = TEmbed(cfg=dataclasses.replace(T_MINILM, **SHAPE, dtype=torch.float32),
                  max_length=32, params=from_jax_params(_np_tree(jemb.params)),
                  tokenizer=TTok(vocab_size=500, max_length=32), device="cpu")
    yield {"jax": jemb, "torch": temb}
    jemb.close()
    temb.close()


def _texts(n, seed=5):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "stream", "tensor", "index", "chip", "fuse"]
    return [" ".join(rng.choice(words, 8)) for _ in range(n)]


def test_config1_csv_embed_jsonlines_equal_jax(models, tmp_path):
    """Config 1 as users write it: CSV files read statically, the embedder
    as a UDF, the vectors written as JSON lines; both packages write the
    same docs once each, vectors within 1e-4."""
    src = tmp_path / "csv"
    src.mkdir()
    texts = _texts(48)
    for f in range(3):
        with open(src / f"part{f}.csv", "w") as fh:
            fh.write("doc,text\n" + "".join(f'{i},"{texts[i]}"\n' for i in range(f, 48, 3)))
    written = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        emb = _llm(pkg).embedders.SentenceTransformerEmbedder(models[pkg], max_batch_size=16)

        class S(pw.Schema):
            doc: int
            text: str

        docs = pw.io.csv.read(str(src), schema=S, mode="static")
        out = tmp_path / f"vecs-{pkg}.jsonl"
        pw.io.jsonlines.write(docs.select(docs.doc, vec=emb(docs.text)), str(out))
        pw.run()
        recs = [json.loads(line) for line in open(out)]
        assert all(r["diff"] == 1 for r in recs)
        written[pkg] = {r["doc"]: np.asarray(r["vec"]) for r in recs}
        assert len(recs) == len(written[pkg]) == 48  # each doc written once
    for i in range(48):
        np.testing.assert_allclose(written["torch"][i], written["jax"][i], rtol=0, atol=ENC_TOL)


def _llm(pkg):
    if pkg == "torch":
        from pathway_tpu_torch.xpacks import llm
    else:
        from pathway_tpu.xpacks import llm
    return llm


def _store_factory(pkg, name, emb):
    ix = PW[pkg].indexing
    knn = ix.BruteForceKnnFactory(**_cpu(pkg, dimensions=64, embedder=emb))
    if name == "brute_force":
        return knn
    if name == "usearch":
        return ix.UsearchKnnFactory(dimensions=64, embedder=emb)
    if name == "bm25":
        return ix.TantivyBM25Factory()
    return ix.HybridIndexFactory([knn, ix.TantivyBM25Factory()])


def _retrieve(live, queries, k):
    return [post_json(f"{live.base}/v1/retrieve", {"query": q, "k": k}) for q in queries]


def _wait_files(live, src):
    """Until the store holds the docs of exactly the files in ``src``:
    its count, then its list of inputs (a scan mid-change can show the
    right count with other files)."""
    names = {p.name for p in src.iterdir()}
    deadline = time.monotonic() + LLM_TIMEOUT
    while time.monotonic() < deadline:
        if post_json(f"{live.base}/v1/statistics", {})["file_count"] == len(names):
            inputs = post_json(f"{live.base}/v1/inputs",
                               {"metadata_filter": None, "filepath_globpattern": None})
            if {m["path"].rsplit("/", 1)[-1] for m in inputs} == names:
                return
        time.sleep(0.05)
    raise AssertionError(f"the store never held the {len(names)} files")


def _serve_store(pkg, name, models, src, queries, k, change=None):
    """Config 2 as users write it: a directory read with ``pw.io.fs.read(
    format="binary", with_metadata=True, mode="streaming")`` into a
    ``DocumentStore`` served by ``DocumentStoreServer`` on port 0. Returns
    the replies to ``queries`` once every file is in; with ``change``,
    also the replies once the store holds the files ``change()`` left,
    and for the hybrid its two sub-indexes' replies at twice k."""
    pw, llm = PW[pkg], _llm(pkg)
    pw.clear_graph()
    emb = llm.embedders.SentenceTransformerEmbedder(models[pkg], max_batch_size=16)
    docs = pw.io.fs.read(str(src), format="binary", with_metadata=True, mode="streaming",
                         refresh_interval=0.05)
    store = llm.DocumentStore(docs, retriever_factory=_store_factory(pkg, name, emb))
    server = llm.servers.DocumentStoreServer("127.0.0.1", 0, store)
    if name == "hybrid":  # its two sub-indexes' own replies, phase 18's routes
        for i in range(2):
            chip_smoke.sub_index_route(pw, store, i, f"/v1/sub{i}", server.webserver)
    live = LiveRun(pkg, webserver=server.webserver)
    try:
        _wait_files(live, src)
        before = _retrieve(live, queries, k)
        after, subs = None, None
        if change is not None:
            change()
            _wait_files(live, src)
            after = _retrieve(live, queries, k)
        if name == "hybrid":
            subs = [[post_json(f"{live.base}/v1/sub{i}", {"query": q, "k": 2 * k})
                     for q in queries] for i in range(2)]
    finally:
        live.stop()
        pw.clear_graph()
    return before, after, subs


def _ranking(reply):
    """A REST reply's docs as the hybrid fuses them: ``repr`` keys of
    (text, metadata) rows, best first, equal distances by key."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing.hybrid_index import canonical_ranking

    return canonical_ranking([(d["text"], pw.Json(d["metadata"])) for d in reply],
                             [d["dist"] for d in reply])


def _strip(reply):
    """A reply's docs without the reader's clock (``seen_at``)."""
    return [{**d, "metadata": {k: v for k, v in d["metadata"].items() if k != "seen_at"}}
            for d in reply]


@pytest.mark.parametrize("name", ["brute_force", "usearch", "bm25"])
def test_config2_document_store_over_fs_equal_jax(models, tmp_path, name):
    src = tmp_path / "docs"
    src.mkdir()
    for i, t in enumerate(_texts(24, seed=9)):
        (src / f"doc{i:03d}.txt").write_bytes(t.encode())
    queries = ["alpha beta stream", "tensor chip", "delta fuse index"]
    replies = {pkg: _serve_store(pkg, name, models, src, queries, 4)[0] for pkg in PACKAGES}
    for got, want in zip(replies["torch"], replies["jax"], strict=True):
        assert len(got) == 4
        g, w = _strip(got), _strip(want)
        np.testing.assert_allclose([d["dist"] for d in g], [d["dist"] for d in w],
                                   rtol=0, atol=ENC_TOL)
        if name == "bm25":
            # equal scores: the same docs, in the order the reply's rows
            # arrived (their ids come from the request's own id)
            assert [d["dist"] for d in g] == [d["dist"] for d in w]
            by_dist = lambda ds: sorted((d["dist"], d["text"], json.dumps(  # noqa: E731
                d["metadata"], sort_keys=True)) for d in ds)
            assert by_dist(g) == by_dist(w)
        else:
            assert [d["text"] for d in g] == [d["text"] for d in w]
            assert [d["metadata"] for d in g] == [d["metadata"] for d in w]


@pytest.mark.parametrize("name", ["brute_force", "hybrid"])
def test_config2_fresh_files_answer_and_deleted_files_retract(models, tmp_path, name):
    """The port's store over a live directory: a new file's doc is
    returned once it is in, a deleted file's doc never again; the hybrid's
    replies equal an RRF of the brute force's and BM25's own replies."""
    from pathway_tpu_torch.stdlib.indexing.hybrid_index import rrf_fuse

    src = tmp_path / "docs"
    src.mkdir()
    texts = _texts(20, seed=11)
    for i, t in enumerate(texts):
        (src / f"doc{i:03d}.txt").write_bytes(t.encode())
    fresh = "zeta omega unique fresh words"
    gone = texts[3]

    def change():
        (src / "doc003.txt").unlink()
        (src / "doc100.txt").write_bytes(fresh.encode())

    queries = [fresh, gone, "alpha stream"]
    before, after, subs = _serve_store("torch", name, models, src, queries, 3, change=change)
    assert gone in [d["text"] for d in before[1]]
    assert after[0][0]["text"] == fresh and after[0][0]["metadata"]["path"].endswith(
        "doc100.txt")
    assert all(d["text"] != gone for reply in after for d in reply)
    if name == "hybrid":
        for q, got, a, b in zip(queries, after, *subs):
            want = rrf_fuse([_ranking(a), _ranking(b)], 3)
            assert chip_smoke.hybrid_keys(got) == [key for key, _s in want], q
            assert [d["dist"] for d in got] == [-s for _key, s in want]
