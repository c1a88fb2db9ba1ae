"""The port's IVF-Flat index against the JAX package (after the IVF cases
of tests/test_indexing.py).

Tolerances, each with its reason:
* ``kmeans_fit``: f32 centroids within 1e-5 (the same blocked one-hot
  sums; the frameworks sum in different orders);
* ``_assign_cells``: candidate cells equal, except where the two scores
  that decide a position lie within 1e-5 (a near-tie the test detects);
* allocators: placements equal (host numpy on both sides);
* f32 cells: search keys equal to JAX's, except among hits whose JAX
  scores lie within 1e-5 relative; scores within 1e-5 relative plus 1e-5
  (squared-L2 scores reach ~10 and come out of ``qn + cn - 2 dots``,
  whose cancellation leaves a few f32 ulps);
* bf16 and int8 cells: by recall (near-ties are common there), with the
  JAX tests' bars.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pathway_tpu.ops import ivf as JI
from pathway_tpu.ops.knn import BruteForceKnnIndex as JIndex
from pathway_tpu_torch.engine import probes as TP
from pathway_tpu_torch.ops import ivf as TI
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

TIE = 1e-5


def _clustered(seed, n, d, n_centers=8, spread=1.0, scale=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)) * scale
    return (centers[rng.integers(0, n_centers, n)]
            + spread * rng.normal(size=(n, d))).astype(np.float32), centers


def _recall(hits, exact, k):
    return np.mean([len({a for a, _ in h} & {b for b, _ in e}) / k
                    for h, e in zip(hits, exact)])


@pytest.mark.parametrize("n,block,iters", [(1000, 256, 3), (700, 8192, 10), (64, 16, 2)])
def test_kmeans_fit_matches_jax(n, block, iters):
    v, _ = _clustered(1, n, 16)
    c0 = v[:: max(1, n // 8)][:8] + 1e-3
    want = np.asarray(JI.kmeans_fit(jnp.asarray(v), jnp.asarray(c0), n_iters=iters,
                                    block=block))
    got = TI.kmeans_fit(torch.from_numpy(v), torch.from_numpy(c0), n_iters=iters,
                        block=block)
    assert got.dtype == torch.float32 and got.shape == (8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TIE)


def test_kmeans_dead_centroid_keeps_its_place():
    v = np.zeros((32, 4), np.float32)
    v[:, 0] = 1.0
    c0 = np.array([[1, 0, 0, 0], [0, 0, 0, 50]], np.float32)
    got = TI.kmeans_fit(torch.from_numpy(v), torch.from_numpy(c0), n_iters=2).numpy()
    assert np.array_equal(got[1], c0[1])
    want = np.asarray(JI.kmeans_fit(jnp.asarray(v), jnp.asarray(c0), n_iters=2))
    np.testing.assert_allclose(got, want, rtol=0, atol=TIE)


@pytest.mark.parametrize("metric,top_c,m", [("cos", 4, 300), ("l2", 8, 50), ("cos", 32, 9)])
def test_assign_cells_matches_jax_but_at_ties(metric, top_c, m, monkeypatch):
    v, _ = _clustered(2, m, 16)
    cents, _ = _clustered(3, 40, 16)
    monkeypatch.setattr(TI, "_ASSIGN_BLOCK", 64)  # the blocked path too
    got = TI._assign_cells(torch.from_numpy(v), torch.from_numpy(cents), metric, top_c).numpy()
    want = np.asarray(JI._assign_cells(jnp.asarray(v), jnp.asarray(cents), metric, top_c))
    assert got.dtype == np.int32 and got.shape == want.shape == (m, min(top_c, 40))
    sc = v @ cents.T
    if metric == "l2":
        sc = -((v * v).sum(1)[:, None] + (cents * cents).sum(1)[None, :] - 2 * sc)
    rows, cols = np.nonzero(got != want)
    for r, c in zip(rows, cols):
        assert abs(sc[r, got[r, c]] - sc[r, want[r, c]]) <= TIE, (r, c)
    assert len(rows) <= m // 20


@pytest.mark.parametrize("seed", [0, 1])
def test_allocators_place_rows_as_jax_does(seed):
    rng = np.random.default_rng(seed)
    cand = np.stack([rng.permutation(16)[:6] for _ in range(400)]).astype(np.int32)
    cand[:120, 0] = 3  # one hot cell: spills and a grow
    places = []
    for mod in (TI, JI):
        kw = {} if mod is JI else {"device": "cpu"}
        ix = mod.IvfFlatIndex(dimensions=4, n_cells=16, nprobe=6, cell_capacity=16, **kw)
        bulk = ix._alloc_rows_bulk(cand)
        ix._free[5].extend([2, 7])
        slow = ix._alloc_rows_slow(cand[:40])
        places.append((bulk, slow, ix.cell_cap, list(ix._fill)))
    (tb, ts, tcap, tfill), (jb, js, jcap, jfill) = places
    for a, b in zip(tb + ts, jb + js):
        assert np.array_equal(a, b)
    assert tcap == jcap and tfill == jfill


def test_ivf_recall_and_deletes():
    """tests/test_indexing.py:182 on the port: recall against brute force
    on clustered data, deletes, the retrain-triggered rebuild."""
    vecs, centers = _clustered(0, 1500, 16)
    rng = np.random.default_rng(9)
    queries = (centers[rng.integers(0, 8, 16)] + rng.normal(size=(16, 16))).astype(np.float32)
    keys = [f"k{i}" for i in range(1500)]
    ivf = TI.IvfFlatIndex(dimensions=16, n_cells=8, nprobe=3, train_after=256, device="cpu")
    bf = BruteForceKnnIndex(dimensions=16, reserved_space=1500, device="cpu")
    for s in range(0, 1500, 300):
        ivf.add(keys[s:s + 300], vecs[s:s + 300])
        bf.add(keys[s:s + 300], vecs[s:s + 300])
    assert ivf._trained and not ivf._pending
    TP.reset_retrieval_backend_stats()
    hits = ivf.search(queries, 5)
    assert TP.retrieval_backend_stats() == {"ivf": 16}
    assert _recall(hits, bf.search(queries, 5), 5) > 0.7
    for row in hits:
        scores = [s for _, s in row]
        assert scores == sorted(scores, reverse=True)
    ivf.remove(keys[:50])
    assert len(ivf) == 1450
    assert all(k != "k0" for k, _ in ivf.search(vecs[:1], 5)[0])


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_add_device_matches_host_add(dtype):
    """tests/test_indexing.py:217: device-resident ingest (on-device
    normalize, device pending chunks, the device rebuild) ranks as the
    host path does, through training."""
    corpus, _ = _clustered(0, 6144, 16, n_centers=16)
    corpus = (corpus / np.linalg.norm(corpus, axis=1, keepdims=True)).astype(np.float32)
    q = corpus[:16]

    def build(dev):
        idx = TI.IvfFlatIndex(dimensions=16, n_cells=32, nprobe=8, metric="cos",
                              cell_capacity=512, train_after=2048, dtype=dtype,
                              device="cpu")
        for s in range(0, 6144, 2048):  # crosses train_after: the rebuild
            if dev:
                idx.add_device(list(range(s, s + 2048)), torch.from_numpy(corpus[s:s + 2048]))
            else:
                idx.add(list(range(s, s + 2048)), corpus[s:s + 2048])
        return idx

    host, dev = build(False), build(True)
    assert dev._trained and isinstance(dev._centroids, torch.Tensor)
    rh, rd = host.search(q, k=5), dev.search(q, k=5)
    assert sum(a[0][0] == b[0][0] for a, b in zip(rh, rd)) >= 15
    assert _recall(rd, rh, 5) >= 0.9
    idx = TI.IvfFlatIndex(dimensions=16, n_cells=8, nprobe=2, device="cpu")
    with pytest.raises(ValueError, match="keys for"):
        idx.add(list(range(10)), corpus[:5])
    with pytest.raises(ValueError, match="keys for"):
        idx.add_device(list(range(10)), torch.from_numpy(corpus[:5]))


def test_bulk_allocator_spills_and_stays_searchable():
    """tests/test_indexing.py:307: the bulk path spills, every vector stays
    findable; removals fill free lists and a re-add takes the slow path."""
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((8, 32)).astype(np.float32)
    corpus = centers[rng.integers(0, 8, 3000)] + 0.1 * rng.standard_normal(
        (3000, 32)).astype(np.float32)
    ix = TI.IvfFlatIndex(dimensions=32, n_cells=16, nprobe=16, metric="cos",
                         cell_capacity=64, train_after=512, device="cpu")
    ix.add(list(range(3000)), corpus)
    assert ix.n == 3000 and len(ix._loc) == 3000 and len(ix._keys) == 3000
    assert all(len(row) == 20 for row in ix.search(centers, k=20))
    ix.remove(list(range(100)))
    ix.add(list(range(100)), corpus[:100])
    assert ix.n == 3000 and int(ix._valid.sum()) == 3000


def test_pretrain_remove_readd_no_duplicates():
    """tests/test_indexing.py:334: a key removed and re-added before
    training survives the rebuild once, with its latest vector."""
    rng = np.random.default_rng(11)
    ix = TI.IvfFlatIndex(dimensions=16, n_cells=4, nprobe=4, metric="cos",
                         cell_capacity=32, train_after=20, device="cpu")
    v1 = rng.standard_normal(16).astype(np.float32)
    ix.add(["k"], v1[None, :])
    ix.remove(["k"])
    ix.add(["k"], -v1[None, :])
    ix.add([f"e{i}" for i in range(20)], rng.standard_normal((20, 16)).astype(np.float32))
    assert ix._trained
    assert ix.n == 21 and len(ix._loc) == 21 and len(ix._keys) == 21
    (row,) = ix.search(-v1[None, :], k=5)
    keys = [k for k, _ in row]
    assert keys.count("k") == 1 and dict(row)["k"] > 0.9


def test_int8_cells_track_bf16_recall():
    """tests/test_indexing.py:469: int8 cells (per-slot scales, integer
    scoring) against bf16 cells, through retrain, grow and deletes."""
    vecs, centers = _clustered(1, 1500, 16)
    rng = np.random.default_rng(2)
    queries = (centers[rng.integers(0, 8, 16)] + rng.normal(size=(16, 16))).astype(np.float32)
    keys = [f"k{i}" for i in range(1500)]
    bf = BruteForceKnnIndex(dimensions=16, reserved_space=1500, device="cpu")
    bf.add(keys, vecs)
    exact = bf.search(queries, 5)
    recalls = {}
    for name, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        ivf = TI.IvfFlatIndex(dimensions=16, n_cells=8, nprobe=4, train_after=256,
                              dtype=dt, device="cpu")
        for s in range(0, 1500, 300):
            ivf.add(keys[s:s + 300], vecs[s:s + 300])
        assert ivf._trained
        assert (ivf._scales is not None) == (name == "int8")
        recalls[name] = _recall(ivf.search(queries, 5), exact, 5)
        if name == "int8":
            assert ivf._cells.dtype == torch.int8
            ivf.remove(keys[:50])
            assert len(ivf) == 1450
            assert all(k != "k0" for k, _ in ivf.search(vecs[:1], 5)[0])
    assert recalls["int8"] >= recalls["bf16"] - 0.1, recalls


def _jax_and_port(metric, dtype_j, dtype_t, **kw):
    return (JI.IvfFlatIndex(dimensions=16, metric=metric, dtype=dtype_j, **kw),
            TI.IvfFlatIndex(dimensions=16, metric=metric, dtype=dtype_t, device="cpu", **kw))


def _keys_equal_but_at_ties(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=TIE, atol=TIE)
        wscore = dict(w)
        for (gk, _), (wk, ws) in zip(g, w):
            if gk != wk:
                assert gk in wscore and abs(wscore[gk] - ws) <= TIE * max(1.0, abs(ws)), (gk, wk)


@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_f32_cells_search_keys_match_jax(metric):
    """One data set through JAX's and the port's index with f32 cells:
    training, spills, a grow, removes and re-adds; the searches agree."""
    vecs, centers = _clustered(5, 1200, 16, spread=0.8)
    rng = np.random.default_rng(6)
    queries = (centers[rng.integers(0, 8, 12)] + rng.normal(size=(12, 16))).astype(np.float32)
    keys = [f"k{i}" for i in range(1200)]
    j, t = _jax_and_port(metric, jnp.float32, torch.float32, n_cells=8, nprobe=3,
                         cell_capacity=48, train_after=300)
    for ix in (j, t):
        for s in range(0, 1200, 400):
            ix.add(keys[s:s + 400], vecs[s:s + 400])
        ix.remove(keys[10:60])
        ix.add(keys[10:30], vecs[10:30])
    assert t._trained and j._trained
    np.testing.assert_allclose(t._centroids.numpy(), np.asarray(j._centroids), rtol=0,
                               atol=TIE)
    assert t.cell_cap == j.cell_cap and t.n == j.n
    assert t._loc == j._loc
    for k in (1, 7, 10):
        _keys_equal_but_at_ties(t.search(queries, k), j.search(queries, k))


def test_search_device_pads_queries_and_empty_index():
    ix = TI.IvfFlatIndex(dimensions=8, n_cells=4, nprobe=2, device="cpu")
    assert ix.search(np.zeros((3, 8), np.float32), 2) == [[], [], []]
    with pytest.raises(ValueError, match="empty"):
        ix.search_device(np.zeros((1, 8), np.float32), 2)
    vecs, _ = _clustered(7, 40, 8)
    ix.add(list(range(40)), vecs)
    scores, cells, slots = ix.search_device(vecs[:3], 5)
    assert scores.shape == cells.shape == slots.shape == (4, 5)  # pow2 bucket
    j = JI.IvfFlatIndex(dimensions=8, n_cells=4, nprobe=2)
    j.add(list(range(40)), vecs)
    _keys_equal_but_at_ties(ix.search(vecs[:3], 5), j.search(vecs[:3], 5))
    ji = JIndex(8, reserved_space=64)
    ji.add(list(range(40)), vecs)
    assert [r[0][0] for r in ix.search(vecs[:3], 1)] == [r[0][0] for r in ji.search(vecs[:3], 1)]
