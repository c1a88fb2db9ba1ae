"""The port's host-side HNSW index against the JAX package's (after
tests/test_hnsw.py:22-75; the dataflow case waits for the port's engine).

Both are host numpy over one algorithm with the RNG drawn in the same
order, so the same seed and inserts must build the same graph: levels,
entry point and every neighbour list equal, search results equal key for
key and score for score.

Run as a script over an ``.npz`` of ``docs`` and ``queries`` (as
``tools/ann_vectors.py`` writes from the card), it prints both indexes'
recall@10 at ``expansion_search`` 64 and 128 against exact f32 scoring:

    JAX_PLATFORMS=cpu python3 -m tests.test_torch_hnsw chiprun_out/ann_vectors.npz
"""

import json
import sys
import time

import numpy as np
import pytest

from pathway_tpu.ops.hnsw import HnswIndex as JHnsw
from pathway_tpu_torch.ops.hnsw import HnswIndex


def _clustered(n, d, rng, n_centers=32):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("metric,seed,kw", [
    ("cos", 0, {}),
    ("l2sq", 3, dict(connectivity=4, expansion_add=16, expansion_search=8)),
    ("cos", 7, dict(connectivity=8, expansion_add=32, expansion_search=16, seed=5)),
])
def test_same_inserts_build_the_same_graph_as_jax(metric, seed, kw):
    rng = np.random.default_rng(seed)
    corpus = _clustered(600, 16, rng)
    queries = _clustered(20, 16, rng)
    j, t = JHnsw(16, metric=metric, **kw), HnswIndex(16, metric=metric, **kw)
    for ix in (j, t):
        for s in range(0, 600, 150):
            ix.add(list(range(s, s + 150)), corpus[s:s + 150])
        ix.remove(list(range(0, 600, 7)))
        ix.add([3, 700], corpus[:2] * 0.5)  # an upsert and a new key
    assert t._levels == j._levels and t._entry == j._entry
    assert t._max_level == j._max_level and t._deleted == j._deleted
    assert t._nbrs == j._nbrs
    assert len(t) == len(j)
    for k in (1, 5, 12):
        assert t.search(queries, k) == j.search(queries, k)


def test_hnsw_recall_cos():
    rng = np.random.default_rng(0)
    n, d, nq, k = 3000, 32, 50, 10
    corpus = _clustered(n, d, rng)
    queries = _clustered(nq, d, rng)
    idx = HnswIndex(d, metric="cos")
    for s in range(0, n, 500):
        idx.add(list(range(s, s + 500)), corpus[s:s + 500])
    truth = np.argsort(-(queries @ corpus.T), axis=1)[:, :k]
    res = idx.search(queries, k)
    recall = np.mean([len({key for key, _ in row} & set(truth[i].tolist())) / k
                      for i, row in enumerate(res)])
    assert recall >= 0.9, recall
    for row in res[:5]:
        scores = [s for _, s in row]
        assert scores == sorted(scores, reverse=True)


def test_hnsw_delete_and_upsert():
    rng = np.random.default_rng(1)
    n, d, k = 1000, 16, 5
    corpus = _clustered(n, d, rng)
    idx = HnswIndex(d, metric="cos")
    idx.add(list(range(n)), corpus)
    dels = list(range(0, n, 3))
    idx.remove(dels)
    assert len(idx) == n - len(dels)
    dset = set(dels)
    for row in idx.search(corpus[:40], k):
        assert all(key not in dset for key, _ in row)
    target = corpus[500]
    idx.add([1], target[None, :])
    assert {key for key, _ in idx.search(target[None, :], 3)[0]} >= {1}


def test_hnsw_l2sq_and_empty():
    rng = np.random.default_rng(2)
    d = 8
    idx = HnswIndex(d, metric="l2sq")
    assert idx.search(rng.standard_normal((2, d)).astype(np.float32), 3) == [[], []]
    pts = rng.standard_normal((200, d)).astype(np.float32)
    idx.add(list(range(200)), pts)
    assert [row[0][0] for row in idx.search(pts[:10], 1)] == list(range(10))


def recall_witness(docs, queries, k: int = 10, batch: int = 512, efs=(64, 128)) -> dict:
    """Recall@k of JAX's and the port's ``HnswIndex`` (default settings,
    inserts in batches of ``batch``) over the same vectors, against exact
    f32 scoring, at each ``expansion_search`` of ``efs``; insert seconds;
    whether the two graphs are equal."""
    truth = np.argsort(-(queries @ docs.T), axis=1, kind="stable")[:, :k]
    ixs = {"jax": JHnsw(docs.shape[1]), "port": HnswIndex(docs.shape[1])}
    out: dict = {}
    for name, ix in ixs.items():
        t0 = time.perf_counter()
        for s in range(0, len(docs), batch):
            ix.add(list(range(s, min(s + batch, len(docs)))), docs[s:s + batch])
        out[name] = {"insert_s": time.perf_counter() - t0}
        for ef in efs:
            ix.ef_search = ef
            hits = ix.search(queries, k)
            out[name][ef] = float(np.mean([len({key for key, _ in h} & set(t.tolist())) / k
                                           for h, t in zip(hits, truth)]))
    out["graph_equal"] = ixs["jax"]._nbrs == ixs["port"]._nbrs
    return out


def test_recall_witness_reads_jax_and_the_port_alike():
    rng = np.random.default_rng(11)
    corpus, queries = _clustered(700, 24, rng), _clustered(30, 24, rng)
    w = recall_witness(corpus, queries, batch=256, efs=(8, 64))
    assert w["graph_equal"]
    assert w["jax"][8] == w["port"][8] and w["jax"][64] == w["port"][64]
    assert w["port"][64] >= 0.9


if __name__ == "__main__":
    data = np.load(sys.argv[1])
    result = recall_witness(data["docs"], data["queries"])
    print(json.dumps({"vectors": sys.argv[1], "gpu": str(data["gpu"]),
                      "shape": list(data["docs"].shape), **result}))
