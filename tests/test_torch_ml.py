"""The port's ``pw.ml`` and ``pw.utils`` held against the JAX package's.

Every case of ``tests/test_ml_lsh.py`` and ``tests/test_fuzzy_join.py``
runs on both packages from the same seeded numpy inputs: the JAX case's
bars hold on the port's result, and the two results are equal (row ids
and values; floats exactly, but the fuzzy-join weights within 1e-9). On
top: bucket ids of both bucketers over seeded vectors, the ``lsh`` rows,
the ``knn_lsh_*`` neighbours and predictions, ``clustering_via_lsh``
labels on seeded blobs (512 x 16, k = 4; the port's k-means on the CPU
here), ``knn_classifier`` against host brute force, the ``pw.utils.col``
helpers, the HMM reducer and ``classifier_accuracy``.

The MNIST case compares the port's loader with JAX's synthetic stand-in:
the JAX loader would try a download first, and nothing here touches the
network."""

import datetime
import warnings

import numpy as np
import pytest

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from tests.torch_engine import PACKAGES, PW, final_state


def _mod(pkg: str, name: str):
    from importlib import import_module

    root = "pathway_tpu" if pkg == "jax" else "pathway_tpu_torch"
    return import_module(f"{root}.{name}")


def _rows(pkg, table):
    """{row id: row} and columns of ``table``'s final state (raw values)."""
    if pkg == "torch":
        from pathway_tpu_torch.internals.run import capture_table
    else:
        from pathway_tpu.internals.run import capture_table
    cap = capture_table(table)
    return {int(k): v for k, v in cap.state.rows.items()}, list(cap.column_names)


def _both(build):
    """(JAX's, the port's) final state of ``build(pkg, pw)``, canonical."""
    out = []
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        out.append(final_state(pkg, build(pkg, pw)))
        pw.clear_graph()
    return tuple(out)


def _both_raw(build):
    out = []
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        out.append(_rows(pkg, build(pkg, pw)))
        pw.clear_graph()
    return tuple(out)


def _ml_kw(pkg):
    """The port's device argument (its entry points default to CUDA)."""
    return {"device": "cpu"} if pkg == "torch" else {}


# ------------------------------------------------------- tests/test_ml_lsh.py

def _two_cluster_tables(pw):
    gen = np.random.default_rng(7)
    a = gen.normal(0.0, 0.05, size=(8, 4))
    b = gen.normal(1.0, 0.05, size=(8, 4)) + np.array([0, 0, 2.0, 2.0])
    full = pw.debug.table_from_rows(
        schema=pw.schema_from_types(data=np.ndarray, label=str),
        rows=[(row, "lo") for row in a] + [(row, "hi") for row in b],
    )
    data = full.select(full.data)
    labels = full.select(full.label)
    queries = pw.debug.table_from_rows(
        schema=pw.schema_from_types(data=np.ndarray),
        rows=[(np.full(4, 0.02),), (np.array([1.0, 1.0, 3.0, 3.0]),)],
    )
    return data, labels, queries


@pytest.mark.parametrize("pkg", PACKAGES)
def test_bucketer_euclidean_shape_and_locality(pkg):
    lsh_mod = _mod(pkg, "stdlib.ml._lsh")
    bucketer = lsh_mod.generate_euclidean_lsh_bucketer(d=4, M=3, L=5, A=2.0)
    near1 = bucketer(np.zeros(4))
    near2 = bucketer(np.full(4, 0.01))
    far = bucketer(np.full(4, 50.0))
    assert near1.shape == (5,)
    assert (near1 == near2).all()
    assert (near1 != far).any()
    again = lsh_mod.generate_euclidean_lsh_bucketer(d=4, M=3, L=5, A=2.0)(np.zeros(4))
    assert (again == near1).all()


def test_bucketer_cosine_band_packing():
    from pathway_tpu_torch.stdlib.ml._lsh import generate_cosine_lsh_bucketer

    out = generate_cosine_lsh_bucketer(d=6, M=4, L=3)(np.ones(6))
    assert out.shape == (3,)
    assert ((0 <= out) & (out < 2**4)).all()


@pytest.mark.parametrize("kind", ["euclidean", "cosine"])
@pytest.mark.parametrize("seed", [0, 5])
def test_bucket_ids_equal_jax(kind, seed):
    """Same planes, shifts and fingerprints: equal ids, bit for bit."""
    from pathway_tpu.stdlib.ml import _lsh as J
    from pathway_tpu_torch.stdlib.ml import _lsh as T

    x = np.random.default_rng(100 + seed).normal(size=(64, 16)) * 3.0
    if kind == "euclidean":
        jb = J.generate_euclidean_lsh_bucketer(16, 4, 6, A=2.0, seed=seed)
        tb = T.generate_euclidean_lsh_bucketer(16, 4, 6, A=2.0, seed=seed)
    else:
        jb = J.generate_cosine_lsh_bucketer(16, 10, 4, seed=seed)
        tb = T.generate_cosine_lsh_bucketer(16, 10, 4, seed=seed)
    for row in x:
        assert np.array_equal(jb(row), tb(row))


def test_fingerprint_equals_jax_in_every_format():
    from pathway_tpu.internals.fingerprints import fingerprint as jf
    from pathway_tpu_torch.internals.fingerprints import _FORMATS, fingerprint as tf

    for fmt in sorted(_FORMATS - {"hash"}):
        for obj in (b"\x01\x02", "abc", 17, (1, 2)):
            assert tf(obj, format=fmt, seed="s") == jf(obj, format=fmt, seed="s")
    with pytest.raises(ValueError):
        tf(1, format="nope")


def test_lsh_flattens_per_band():
    def build(pkg, pw):
        data = pw.debug.table_from_rows(
            schema=pw.schema_from_types(data=np.ndarray),
            rows=[(np.zeros(4),), (np.ones(4),)],
        )
        lsh_mod = _mod(pkg, "stdlib.ml._lsh")
        return lsh_mod.lsh(data, lsh_mod.generate_euclidean_lsh_bucketer(d=4, M=2, L=3, A=1.0))

    (jrows, jcols), (trows, tcols) = _both(build)
    assert set(tcols) == {"origin_id", "bucketing", "band", "data"}
    assert len(trows) == 2 * 3
    bands = sorted(r[tcols.index("bucketing")] for r in trows.values())
    assert bands == [0, 0, 1, 1, 2, 2]
    assert (trows, tcols) == (jrows, jcols)


def test_lsh_rows_equal_jax_on_seeded_vectors():
    x = np.random.default_rng(11).normal(size=(40, 8))

    def build(pkg, pw):
        data = pw.debug.table_from_rows(schema=pw.schema_from_types(data=np.ndarray),
                                        rows=[(r,) for r in x])
        lsh_mod = _mod(pkg, "stdlib.ml._lsh")
        return lsh_mod.lsh(data, lsh_mod.generate_cosine_lsh_bucketer(8, 3, 4, seed=2),
                           include_data=False)

    j, t = _both(build)
    assert len(t[0]) == 40 * 4
    assert t == j


def test_knn_lsh_classifier_end_to_end():
    def build(pkg, pw):
        data, labels, queries = _two_cluster_tables(pw)
        cls = _mod(pkg, "stdlib.ml.classifiers")
        model = cls.knn_lsh_classifier_train(data, L=4, type="euclidean", d=4, M=2, A=4.0)
        return cls.knn_lsh_classify(model, labels, queries, k=3)

    j, (trows, tcols) = _both(build)
    got = [r[tcols.index("predicted_label")] for r in trows.values()]
    assert sorted(x for x in got if x is not None) == ["hi", "lo"]
    assert (trows, tcols) == j


def test_knn_lsh_cosine_and_euclidean_trainers():
    def build_e(pkg, pw):
        data, _, queries = _two_cluster_tables(pw)
        cls = _mod(pkg, "stdlib.ml.classifiers")
        return cls.knn_lsh_euclidean_classifier_train(data, d=4, M=2, L=4, A=4.0)(queries, k=2)

    def build_c(pkg, pw):
        data, _, queries = _two_cluster_tables(pw)
        cls = _mod(pkg, "stdlib.ml.classifiers")
        model = cls.knn_lsh_classifier_train(data, L=4, type="cosine", d=4, M=3)
        return model(queries, k=2, with_distances=True)

    j, (rows, cols) = _both(build_e)
    for r in rows.values():
        assert len(r[cols.index("knns_ids")]) <= 2
    assert (rows, cols) == j
    j, (rows, cols) = _both_raw(build_c)
    for r in rows.values():
        for _, dist in r[cols.index("knns_ids_with_dists")]:
            assert dist >= -1e-6
    jrows, _ = j
    for key, r in rows.items():
        want = jrows[key][cols.index("knns_ids_with_dists")]
        got = r[cols.index("knns_ids_with_dists")]
        assert [p.value for p, _ in got] == [p.value for p, _ in want]
        assert [d for _, d in got] == [d for _, d in want]


def test_knn_lsh_classifier_rejects_unknown_type():
    from pathway_tpu_torch.stdlib.ml.classifiers import knn_lsh_classifier_train

    data, _, _ = _two_cluster_tables(TPW)
    with pytest.raises(ValueError):
        knn_lsh_classifier_train(data, L=2, type="manhattan", d=4, M=2, A=1.0)


def test_clustering_via_lsh_separates_blobs():
    gen = np.random.default_rng(3)
    a = gen.normal(0.0, 0.03, size=(6, 4))
    b = a + 8.0

    def build(pkg, pw):
        data = pw.debug.table_from_rows(
            schema=pw.schema_from_types(data=np.ndarray),
            rows=[(row,) for row in np.vstack([a, b])],
        )
        lsh_mod = _mod(pkg, "stdlib.ml._lsh")
        cls = _mod(pkg, "stdlib.ml.classifiers")
        bucketer = lsh_mod.generate_euclidean_lsh_bucketer(d=4, M=2, L=4, A=4.0)
        return cls.clustering_via_lsh(data, bucketer, k=2, **_ml_kw(pkg))

    j, (rows, cols) = _both(build)
    labels = [r[cols.index("label")] for r in rows.values()]
    assert len(rows) == 12
    assert len(set(labels)) == 2
    assert (rows, cols) == j


@pytest.mark.parametrize("seed", [0, 1])
def test_clustering_via_lsh_labels_equal_jax_on_seeded_blobs(seed):
    """512 x 16 in 4 blobs, k = 4: the port's labels are JAX's, row by row
    (ids included); the init picks ties in ``w`` the same way."""
    gen = np.random.default_rng(50 + seed)
    centers = gen.normal(0.0, 4.0, size=(4, 16))
    x = (centers[gen.integers(0, 4, size=512)] + gen.normal(0, 0.5, size=(512, 16)))
    x = x.astype(np.float32)

    def build(pkg, pw):
        data = pw.debug.table_from_rows(schema=pw.schema_from_types(data=np.ndarray),
                                        rows=[(r,) for r in x])
        lsh_mod = _mod(pkg, "stdlib.ml._lsh")
        cls = _mod(pkg, "stdlib.ml.classifiers")
        return cls.clustering_via_lsh(
            data, lsh_mod.generate_cosine_lsh_bucketer(16, M=6, L=4, seed=seed), k=4,
            **_ml_kw(pkg))

    j, t = _both(build)
    assert len(t[0]) == 512
    assert t == j


def test_clustering_via_lsh_refuses_the_cpu_unless_asked(monkeypatch):
    import torch

    from pathway_tpu_torch.stdlib.ml._lsh import generate_cosine_lsh_bucketer
    from pathway_tpu_torch.stdlib.ml.classifiers import clustering_via_lsh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = TPW.debug.table_from_rows(schema=TPW.schema_from_types(data=np.ndarray),
                                     rows=[(np.ones(4),)])
    with pytest.raises(RuntimeError, match="CUDA"):
        clustering_via_lsh(data, generate_cosine_lsh_bucketer(4, 2, 2), k=1)


def test_kmeans_labels_keep_tf32_off():
    """The k-means products run with TF32 off and the flag is restored."""
    import torch

    from pathway_tpu_torch.stdlib.ml.classifiers import _kmeans_labels

    seen = []
    orig = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return orig(a, b)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        torch.Tensor.__matmul__ = spy
        vecs = np.random.default_rng(0).normal(size=(20, 4)).tolist()
        labels = _kmeans_labels(vecs, [1.0] * 20, 3, torch.device("cpu"))
    finally:
        torch.Tensor.__matmul__ = orig
        restored = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen and not any(seen)
    assert restored is True
    assert len(labels) == 20 and set(labels) <= {0, 1, 2}


def test_knn_classifier_equals_host_majority():
    gen = np.random.default_rng(9)
    x = gen.normal(size=(60, 8)).astype(np.float32)
    lab = gen.integers(0, 3, size=60)
    q = gen.normal(size=(5, 8)).astype(np.float32)
    pw = TPW
    full = pw.debug.table_from_rows(schema=pw.schema_from_types(data=np.ndarray, label=int),
                                    rows=[(r, int(v)) for r, v in zip(x, lab)])
    queries = pw.debug.table_from_rows(schema=pw.schema_from_types(data=np.ndarray),
                                       rows=[(r,) for r in q])
    from pathway_tpu_torch.stdlib.ml.classifiers import knn_classifier

    out = knn_classifier(full.select(full.data), full.select(full.label), queries, k=5,
                         n_dimensions=8, device="cpu")
    rows, cols = _rows("torch", out)
    qrows, _ = _rows("torch", queries)
    from collections import Counter

    for key, r in rows.items():
        qv = np.asarray(qrows[key][0])
        d = ((x - qv) ** 2).sum(axis=1)
        top = np.argsort(d, kind="stable")[:5]
        counts = Counter(int(lab[i]) for i in top).most_common()
        best = [v for v, c in counts if c == counts[0][1]]
        assert r[cols.index("predicted_label")] in best


def test_classifier_accuracy_counts_matches():
    def build(pkg, pw):
        exact = pw.debug.table_from_markdown(
            """
            label
            a
            a
            b
            """
        )
        predicted = exact.select(predicted_label=pw.this.label)
        return _mod(pkg, "stdlib.ml.utils").classifier_accuracy(predicted, exact)

    j, (rows, cols) = _both(build)
    by_match = {r[cols.index("value")]: r[cols.index("cnt")] for r in rows.values()}
    assert by_match == {True: 3}
    assert (rows, cols) == j


def test_apply_all_rows_and_majority():
    def build_shift(pkg, pw):
        t = pw.debug.table_from_markdown(
            """
            a
            1
            2
            3
            """
        )
        col = _mod(pkg, "stdlib.utils.col")
        return col.apply_all_rows(t.a, fun=lambda xs: [x + sum(xs) for x in xs],
                                  result_col_name="res")

    def build_majority(pkg, pw):
        votes = pw.debug.table_from_markdown(
            """
            grp | vote
            x   | 1
            x   | 1
            x   | 2
            y   | 5
            """
        )
        return _mod(pkg, "stdlib.utils.col").groupby_reduce_majority(votes.grp, votes.vote)

    j, (rows, cols) = _both(build_shift)
    assert sorted(r[cols.index("res")] for r in rows.values()) == [7, 8, 9]
    assert (rows, cols) == j
    j, (rows, cols) = _both(build_majority)
    got = {r[cols.index("grp")]: r[cols.index("majority")] for r in rows.values()}
    assert got == {"x": 1, "y": 5}
    assert (rows, cols) == j


def test_unpack_col_dict_and_flatten_column():
    def build_dict(pkg, pw):
        t = pw.debug.table_from_rows(
            schema=pw.schema_from_types(data=dict),
            rows=[
                ({"field_a": 13, "field_b": "foo", "field_c": False},),
                ({"field_a": 17, "field_c": True, "field_d": 3.4},),
            ],
        )

        class DataSchema(pw.Schema):
            field_a: int
            field_b: str | None
            field_c: bool
            field_d: float | None

        return _mod(pkg, "stdlib.utils.col").unpack_col_dict(t.data, schema=DataSchema)

    def build_flat(pkg, pw):
        t2 = pw.debug.table_from_rows(schema=pw.schema_from_types(xs=tuple),
                                      rows=[((1, 2),), ((3,),)])
        with pytest.warns(DeprecationWarning):
            return _mod(pkg, "stdlib.utils.col").flatten_column(t2.xs)

    j, (rows, cols) = _both(build_dict)
    by_a = {r[cols.index("field_a")]: r for r in rows.values()}
    assert by_a[13][cols.index("field_b")] == "foo"
    assert by_a[17][cols.index("field_b")] is None
    assert by_a[17][cols.index("field_d")] == pytest.approx(3.4)
    assert (rows, cols) == j
    j, (rows, cols) = _both(build_flat)
    assert sorted(r[cols.index("xs")] for r in rows.values()) == [1, 2, 3]
    assert (rows, cols) == j


def test_unpack_col_and_multiapply_all_rows():
    def build_unpack(pkg, pw):
        t = pw.debug.table_from_rows(schema=pw.schema_from_types(p=tuple),
                                     rows=[((1, "a"),), ((2, "b"),)])
        return _mod(pkg, "stdlib.utils.col").unpack_col(t.p, "n", "s")

    def build_multi(pkg, pw):
        t = pw.debug.table_from_markdown(
            """
            a | b
            1 | 10
            2 | 20
            4 | 40
            """
        )
        return _mod(pkg, "stdlib.utils.col").multiapply_all_rows(
            t.a, t.b, fun=lambda xs, ys: ([x * sum(ys) for x in xs], [y - min(xs) for y in ys]),
            result_col_names=["p", "q"])

    j, (rows, cols) = _both(build_unpack)
    assert sorted((r[cols.index("n")], r[cols.index("s")]) for r in rows.values()) == [
        (1, "a"), (2, "b")]
    assert (rows, cols) == j
    j, (rows, cols) = _both(build_multi)
    assert sorted(r[cols.index("p")] for r in rows.values()) == [70, 140, 280]
    assert (rows, cols) == j


def test_filtering_argmin_argmax_rows():
    def build(which):
        def b(pkg, pw):
            t = pw.debug.table_from_markdown(
                """
                g | v
                a | 3
                a | 1
                b | 7
                b | 9
                """
            )
            f = getattr(_mod(pkg, "stdlib.utils.filtering"), which)
            return f(t, t.g, what=t.v)

        return b

    j, (rows, cols) = _both(build("argmin_rows"))
    assert sorted(r[cols.index("v")] for r in rows.values()) == [1, 7]
    assert (rows, cols) == j
    j, (rows, cols) = _both(build("argmax_rows"))
    assert sorted(r[cols.index("v")] for r in rows.values()) == [3, 9]
    assert (rows, cols) == j


def test_truncate_to_minutes():
    from pathway_tpu_torch.stdlib.utils.bucketing import truncate_to_minutes

    t = datetime.datetime(2024, 5, 1, 10, 30, 45, 123456)
    assert truncate_to_minutes(t) == datetime.datetime(2024, 5, 1, 10, 30)


def test_load_mnist_sample_offline():
    from pathway_tpu.stdlib.ml.datasets import _synthetic_mnist
    from pathway_tpu_torch.stdlib.ml.datasets import load_mnist_sample

    with pytest.warns(UserWarning, match="synthetic"):
        X_train, y_train, X_test, y_test = load_mnist_sample(sample_size=70)
    rows, cols = _rows("torch", X_train)
    assert len(rows) == 60
    (vec,) = rows[next(iter(rows))]
    assert np.asarray(vec).shape == (784,)
    rows, _ = _rows("torch", y_test)
    assert len(rows) == 10
    # the stand-in is JAX's, value for value
    X, y = _synthetic_mnist(7000)
    got = sorted(tuple(np.asarray(v[0])[:4]) for v in _rows("torch", X_train)[0].values())
    assert got == sorted(tuple(r[:4]) for r in X[:60])


def test_load_mnist_sample_makes_no_network_request(monkeypatch):
    import socket
    import sys

    from pathway_tpu_torch.stdlib.ml import datasets

    def no_socket(*a, **kw):
        raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "socket", no_socket)
    monkeypatch.setitem(sys.modules, "sklearn", None)  # and no sklearn import
    with pytest.raises(OSError):
        datasets._download_mnist()
    with pytest.warns(UserWarning, match="synthetic"):
        X_train, _, _, _ = datasets.load_mnist_sample(sample_size=14)
    assert len(_rows("torch", X_train)[0]) == 12


def test_parallel_tuple_reducers_stay_aligned_with_duplicates():
    def build(pkg, pw):
        t = pw.debug.table_from_rows(
            schema=pw.schema_from_types(g=str, i=str, v=str),
            rows=[("x", "id1", "A"), ("x", "id2", "B"), ("x", "id3", "A")],
        )
        return t.groupby(t.g).reduce(ids=pw.reducers.tuple(t.i), vals=pw.reducers.tuple(t.v))

    j, (rows, cols) = _both(build)
    (row,) = rows.values()
    pairing = dict(zip(row[cols.index("ids")], row[cols.index("vals")]))
    assert pairing == {"id1": "A", "id2": "B", "id3": "A"}
    assert (rows, cols) == j


def test_flatten_rejects_colliding_origin_id():
    t = TPW.debug.table_from_rows(
        schema=TPW.schema_from_types(xs=tuple, label=str),
        rows=[((1, 2), "a")],
    )
    with pytest.raises(ValueError, match="origin_id"):
        t.flatten(t.xs, origin_id="label")


def test_hmm_reducer_decodes_like_jax():
    import networkx as nx

    def graph():
        g = nx.DiGraph()
        g.add_node("lo", calc_emission_log_ppb=lambda o: -abs(o - 0.0))
        g.add_node("hi", calc_emission_log_ppb=lambda o: -abs(o - 10.0))
        for u in ("lo", "hi"):
            for v in ("lo", "hi"):
                g.add_edge(u, v, log_transition_ppb=-0.1 if u == v else -3.0)
        return g

    def build(pkg, pw):
        t = pw.debug.table_from_rows(
            schema=pw.schema_from_types(k=str, obs=float, t=int),
            rows=[("a", v, i) for i, v in enumerate([0.1, 9.0, 9.5, 0.2, 1.0])]
            + [("b", v, i) for i, v in enumerate([10.0, 10.0])],
        )
        reducer = _mod(pkg, "stdlib.ml.hmm").create_hmm_reducer(graph(), beam_size=2,
                                                                  num_results_kept=4)
        return t.groupby(t.k).reduce(t.k, decoded=reducer(t.obs, t.t))

    j, (rows, cols) = _both(build)
    got = {r[cols.index("k")]: r[cols.index("decoded")] for r in rows.values()}
    assert got == {"a": ("hi", "hi", "lo", "lo"), "b": ("hi", "hi")}
    assert (rows, cols) == j


def test_pw_ml_and_utils_names_equal_jax():
    assert sorted(TPW.ml.__all__) == sorted(JPW.ml.__all__)
    assert sorted(TPW.utils.__all__) == sorted(JPW.utils.__all__)
    import types

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")
                and not isinstance(getattr(m, n), types.ModuleType)}

    for mod in ("classifiers", "smart_table_ops", "hmm", "utils", "datasets"):
        j, t = public(getattr(JPW.ml, mod)), public(getattr(TPW.ml, mod))
        assert j - t == set(), (mod, j - t)


# ---------------------------------------------------- tests/test_fuzzy_join.py

def _name_tables(pw):
    left = pw.debug.table_from_markdown(
        """
        name
        john_smith_inc
        acme_corp_ltd
        zeta_systems
        """
    ).select(name=pw.apply(lambda s: s.replace("_", " "), pw.this.name))
    right = pw.debug.table_from_markdown(
        """
        name
        smith_john_company
        ltd_acme_corp
        other_thing
        """
    ).select(name=pw.apply(lambda s: s.replace("_", " "), pw.this.name))
    return left, right


def _fuzzy_both(build):
    """Both packages' (left id, right id) -> weight, and each side's names:
    equal pairs, weights within 1e-9."""
    out = []
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        result, left, right = build(pkg, pw)
        rows, cols = _rows(pkg, result)
        names = []
        for side in (left, right):
            srows, _ = _rows(pkg, side) if side is not None else ({}, [])
            names.append({k: v[0] for k, v in srows.items()})
        pairs = {(r[cols.index("left")].value, r[cols.index("right")].value):
                 r[cols.index("weight")] for r in rows.values()}
        out.append((pairs, names))
        pw.clear_graph()
    (jp, _), (tp, names) = out
    assert set(tp) == set(jp)
    for k in tp:
        assert abs(tp[k] - jp[k]) <= 1e-9
    return tp, names


def _by_name(pairs, names):
    lname, rname = names
    return {lname[lp]: (rname[rp], w) for (lp, rp), w in pairs.items()}


def test_fuzzy_match_tables_aligns_similar_names():
    def build(pkg, pw):
        left, right = _name_tables(pw)
        ops = _mod(pkg, "stdlib.ml.smart_table_ops")
        return ops.fuzzy_match_tables(left, right), left, right

    got = _by_name(*_fuzzy_both(build))
    assert got["john smith inc"][0] == "smith john company"
    assert got["acme corp ltd"][0] == "ltd acme corp"
    assert "zeta systems" not in got
    assert got["john smith inc"][1] > 0


def test_smart_fuzzy_match_normalization_none_counts_tokens():
    def build(pkg, pw):
        left, right = _name_tables(pw)
        ops = _mod(pkg, "stdlib.ml.smart_table_ops")
        return (ops.smart_fuzzy_match(left.name, right.name,
                                      normalization=ops.FuzzyJoinNormalization.NONE),
                left, right)

    got = _by_name(*_fuzzy_both(build))
    assert got["acme corp ltd"][1] == pytest.approx(6.0)


def test_fuzzy_self_match_pairs_duplicates():
    def build(pkg, pw):
        t = pw.debug.table_from_markdown(
            """
            name
            alpha_beta
            beta_alpha
            gamma_delta
            delta_gamma
            """
        ).select(name=pw.apply(lambda s: s.replace("_", " "), pw.this.name))
        return _mod(pkg, "stdlib.ml.smart_table_ops").smart_fuzzy_match(t.name, t.name), t, t

    tp, (name_of, _) = _fuzzy_both(build)
    pairs = {frozenset((name_of[lp], name_of[rp])) for lp, rp in tp}
    assert frozenset(("alpha beta", "beta alpha")) in pairs
    assert frozenset(("gamma delta", "delta gamma")) in pairs
    assert len(tp) == 2


def test_letters_feature_generation():
    def build(pkg, pw):
        left = pw.debug.table_from_markdown(
            """
            name
            abc
            """
        )
        right = pw.debug.table_from_markdown(
            """
            name
            bca
            xyz
            """
        )
        ops = _mod(pkg, "stdlib.ml.smart_table_ops")
        return (ops.smart_fuzzy_match(
            left.name, right.name,
            feature_generation=ops.FuzzyJoinFeatureGeneration.LETTERS), left, right)

    got = _by_name(*_fuzzy_both(build))
    assert got["abc"][0] == "bca"


def _projection_tables(pw):
    left = pw.debug.table_from_rows(
        schema=pw.schema_from_types(first=str, last=str),
        rows=[("ann", "kowalski"), ("bob", "nowak")],
    )
    right = pw.debug.table_from_rows(
        schema=pw.schema_from_types(given=str, family=str),
        rows=[("kowalski", "ann"), ("nowak", "bob")],
    )
    return left, right


def test_projection_buckets_restrict_matching():
    def build(pkg, pw):
        left, right = _projection_tables(pw)
        result = _mod(pkg, "stdlib.ml.smart_table_ops").fuzzy_match_tables(
            left, right,
            left_projection={"first": "b1", "last": "b2"},
            right_projection={"family": "b1", "given": "b2"},
        )
        return result, left, right.select(right.family)

    tp, (lfirst, rfam) = _fuzzy_both(build)
    assert tp
    for lp, rp in tp:
        assert lfirst[lp] == rfam[rp]


def test_by_hand_match_weight_not_multiplied_by_buckets():
    def build(pkg, pw):
        left, right = _projection_tables(pw)
        lrows, _ = _rows(pkg, left)
        rrows, _ = _rows(pkg, right)
        ann_l = next(k for k, v in lrows.items() if v[0] == "ann")
        ann_r = next(k for k, v in rrows.items() if v[1] == "ann")
        hand = pw.debug.table_from_rows(
            schema=pw.schema_from_types(left=object, right=object, weight=float),
            rows=[(pw.Pointer(ann_l), pw.Pointer(ann_r), 1.0)],
        )
        result = _mod(pkg, "stdlib.ml.smart_table_ops").fuzzy_match_tables(
            left, right, by_hand_match=hand,
            left_projection={"first": "b1", "last": "b2"},
            right_projection={"family": "b1", "given": "b2"},
        )
        return result, left, right

    tp, (lname, _) = _fuzzy_both(build)
    weights = {lname[lp]: w for (lp, _), w in tp.items()}
    assert weights["ann"] == pytest.approx(1.0)


@pytest.mark.parametrize("norm", ["WEIGHT", "LOGWEIGHT", "NONE"])
def test_fuzzy_pairs_and_weights_equal_jax_on_seeded_texts(norm):
    """120 seeded texts against copies with one word changed, over a
    threshold low enough that heavy features take part (70% or more matched
    to their original): equal pairs,
    weights within 1e-9."""
    gen = np.random.default_rng(21)
    words = ["w%d" % i for i in range(60)]
    texts = [" ".join(gen.choice(words, 6)) for _ in range(120)]
    changed = []
    for t in texts:
        ws = t.split()
        ws[int(gen.integers(0, len(ws)))] = "zz%d" % int(gen.integers(0, 1000))
        changed.append(" ".join(ws))

    def build(pkg, pw):
        left = pw.debug.table_from_rows(schema=pw.schema_from_types(s=str),
                                        rows=[(t,) for t in texts])
        right = pw.debug.table_from_rows(schema=pw.schema_from_types(s=str),
                                         rows=[(t,) for t in changed])
        ops = _mod(pkg, "stdlib.ml.smart_table_ops")
        return (ops.smart_fuzzy_match(left.s, right.s,
                                      normalization=getattr(ops.FuzzyJoinNormalization, norm),
                                      HEAVY_LIGHT_THRESHOLD=20), left, right)

    tp, (lname, rname) = _fuzzy_both(build)
    hits = sum(changed.index(rname[rp]) == texts.index(lname[lp]) for lp, rp in tp)
    assert hits >= 0.7 * len(texts)


def test_fuzzy_enums_equal_jax():
    from pathway_tpu.stdlib.ml import smart_table_ops as J
    from pathway_tpu_torch.stdlib.ml import smart_table_ops as T

    for name in ("FuzzyJoinFeatureGeneration", "FuzzyJoinNormalization"):
        assert [(m.name, int(m)) for m in getattr(T, name)] == [
            (m.name, int(m)) for m in getattr(J, name)]
    for cnt in (0, 1, 2, 3, 7, 100):
        for m in T.FuzzyJoinNormalization:
            assert m.normalize(cnt) == J.FuzzyJoinNormalization(int(m)).normalize(cnt)
    assert T.FuzzyJoinFeatureGeneration.LETTERS.generate("Ab-1") == ["a", "b", "1"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert T.FuzzyJoinFeatureGeneration.AUTO.generate("x y") == ["x", "y"]


# ------------------------------------------- chip_smoke.py phase 21 (a), small

@pytest.fixture(scope="module")
def small_encoder():
    import dataclasses

    import torch

    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.models.transformer import MINILM_L6

    cfg = dataclasses.replace(MINILM_L6, layers=2, hidden=32, heads=4, intermediate=64,
                              vocab_size=500, max_position=64, dtype=torch.float32)
    m = SentenceEmbedderModel(cfg, max_length=32, device="cpu",
                              tokenizer=HashTokenizer(vocab_size=500, max_length=32))
    yield m
    m.close()


@pytest.mark.timeout(300)
def test_phase21_ml_program_at_a_small_size(small_encoder):
    """Phase 21 (a)'s program and checks at 2,048 docs with the small
    encoder on the CPU: the engine's representatives are the host's groups
    in the engine's order, the labels agree with the host clustering, the
    predictions with the host's exact top k."""
    import chip_smoke
    from pathway_tpu_torch.stdlib.ml._lsh import generate_cosine_lsh_bucketer
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    docs, queries = chip_smoke.corpus(n_queries=16)
    emb = SentenceTransformerEmbedder(small_encoder, max_batch_size=256)
    out = chip_smoke.ml_program(TPW, emb, docs[:2048], queries, dims=32, k=8, knn_k=5,
                                device="cpu",
                                bucketer=generate_cosine_lsh_bucketer(32, M=6, L=4, seed=0))
    chk = chip_smoke.ml_check(out, 8, 5)
    assert chk["n"] == 2048 and len(out["labels"]) == 2048 and chk["n_q"] == 16
    assert chk["bad"] <= 0.01 * chk["n"]
    assert chk["agree"] + chk["boundary"] == 16
    assert 0 < chk["reps"] <= 4 * 64


@pytest.mark.timeout(300)
def test_deferred_embed_udf_gives_the_same_labels_with_more_clusterings(small_encoder):
    """Why phase 21 (a) embeds with the blocking UDF: the deferred one's
    chunks land over several epochs and the clustering, a whole-table
    step, reruns at each. Both runs' final labels pass the same checks
    (where a doc's band votes tie they may differ: the vote order follows
    the updates)."""
    import chip_smoke
    from pathway_tpu_torch.stdlib.ml._lsh import generate_cosine_lsh_bucketer
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    docs, queries = chip_smoke.corpus(n_queries=4)
    got = {}
    for deferred in (False, True):
        emb = SentenceTransformerEmbedder(small_encoder, max_batch_size=128, deferred=deferred)
        out = chip_smoke.ml_program(TPW, emb, docs[:1024], queries, dims=32, k=8, knn_k=3,
                                    device="cpu",
                                    bucketer=generate_cosine_lsh_bucketer(32, M=6, L=4, seed=0))
        chk = chip_smoke.ml_check(dict(out, kmeans_in=out["kmeans_in"][-1:]), 8, 3)
        assert chk["bad"] <= 0.01 * chk["n"]
        got[deferred] = (out["labels"], len(out["kmeans_in"]))
    assert got[True][0].keys() == got[False][0].keys()
    assert got[False][1] == 1 < got[True][1]


def test_phase21_fuzzy_arm_matches_changed_copies():
    import chip_smoke

    docs, _ = chip_smoke.corpus(n_queries=1)
    out = chip_smoke.fuzzy_arm(TPW, docs[:128])
    hits = sum(i == j for i, j in out["pairs"])
    assert hits >= 0.95 * 128 and out["wall_s"] > 0


def test_phase21_heads_split_over_two_replicas():
    import chip_smoke
    from pathway_tpu_torch import serving
    from pathway_tpu_torch.serving.router import FleetRouter

    firsts, rest = chip_smoke.p21_prompts()
    assert len(firsts) == 4 and len(rest) == 28
    router = FleetRouter()
    for rid in ("replica-0", "replica-1"):
        router.ring.add(rid)
    owners = [router.ring.lookup(router.route_key(p)) for p in firsts]
    assert sorted(owners) == ["replica-0", "replica-0", "replica-1", "replica-1"]
    for h, first in enumerate(firsts):
        group = rest[h * 7:(h + 1) * 7]
        assert all(p[:256] == first[:256] for p in group)
        assert {router.ring.lookup(router.route_key(p)) for p in group} == {owners[h]}
    assert serving.affinity_block_tokens() == 64
