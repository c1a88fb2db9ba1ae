"""The port's parallel layer against the JAX package's: mesh shapes,
sharded tensors and collectives, corpus-sharded KNN and IVF with their
top-k merge, ring attention. The port's meshes are virtual: 8 positions
on the CPU (``[cpu] * 8``), the counterpart of the conftest's 8 host
devices that the JAX side runs on.

Not carried over from ``tests/test_parallel.py``:
``test_dp_tp_sharded_train_step`` waits for ``models/train.py`` (ROADMAP
A12), and ``test_graft_entry_contracts`` drives the JAX package's graft
entry, which has no port counterpart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from pathway_tpu import parallel as JPAR
from pathway_tpu.models import transformer as JT
from pathway_tpu.parallel.mesh import compat_shard_map
from pathway_tpu_torch import parallel as TPAR
from pathway_tpu_torch.models import transformer as TT
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    ShardedTensor,
    all_gather,
    all_reduce_sum,
    axis_shards,
    split,
)

CPU8 = [torch.device("cpu")] * 8


def _keys(row):
    return {int(key[1:]) for key, _ in row}


def _numpy_top(vecs, q, k):
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    s = qn @ vn.T
    return [set(np.argsort(-s[r])[:k].tolist()) for r in range(len(q))]


def test_make_mesh_shapes():
    mesh = TPAR.make_mesh(CPU8)
    assert mesh.size == 8 and mesh.shape == {"dp": 8, "tp": 1}
    mesh2 = TPAR.make_mesh(CPU8, dp=4, tp=2)
    assert mesh2.shape["dp"] == 4 and mesh2.shape["tp"] == 2
    assert mesh2.coords(5) == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError):
        TPAR.make_mesh(CPU8, dp=3, tp=2)


def test_meshes_over_default_devices_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TPAR.make_mesh, TPAR.make_serving_mesh, TPAR.local_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_sharded_tensor_place_gather_local_and_collectives():
    mesh = TPAR.make_serving_mesh(CPU8, data=1, fsdp=2, tp=4)
    t = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    st = ShardedTensor.place(t, mesh, P("fsdp", None, "tp"))
    assert len(st.shards) == 8 and tuple(st.shape) == (2, 8, 3)
    assert all(s.is_contiguous() for s in st.shards)
    assert torch.equal(st.gather(), t)
    for i in range(4):  # ZeRO-3 gather on use of one tp coordinate
        assert torch.equal(st.local("tp", i), t[:, :, 3 * i:3 * i + 3])
    # replicated over fsdp on one device: the positions share one tensor
    h = split(t, 1, mesh)
    assert len(h.shards) == 4 and h.index == (0, 1, 2, 3, 0, 1, 2, 3)
    assert h.numel() == t.numel()
    assert set(h.position_bytes().values()) == {t.numel() * 4 // 4}
    # torch ops run per shard and keep the layout; writes land in place
    y = torch.where(torch.tensor(True), h * 2.0, h.float())
    assert isinstance(y, ShardedTensor)
    assert torch.equal(all_gather(axis_shards(y), 1), t * 2.0)
    h[:, :, 0] = -1.0
    assert torch.equal(all_gather(axis_shards(h), 1)[:, :, 0], torch.full((4, 8), -1.0))
    parts = [torch.full((3,), float(i)) for i in range(4)]
    assert torch.equal(all_reduce_sum(parts), torch.full((3,), 6.0))


@pytest.fixture(scope="module")
def knn_data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(256, 16)), rng.normal(size=(3, 16))


def test_sharded_knn_exact_vs_numpy_and_jax(knn_data):
    vecs, q = knn_data
    t_idx = TPAR.ShardedKnnIndex(TPAR.make_mesh(CPU8, tp=1), dimensions=16,
                                 reserved_space=256)
    j_idx = JPAR.ShardedKnnIndex(JPAR.make_mesh(tp=1), dimensions=16,
                                 reserved_space=256)
    for i in range(256):
        t_idx.add(f"k{i}", vecs[i])
        j_idx.add(f"k{i}", vecs[i])
    got, want = t_idx.search(q, k=5), j_idx.search(q, k=5)
    for r, expect in enumerate(_numpy_top(vecs, q, 5)):
        assert _keys(got[r]) == expect == _keys(want[r])
        np.testing.assert_allclose([s for _, s in got[r]], [s for _, s in want[r]],
                                   rtol=1e-5, atol=1e-5)


def test_sharded_knn_delete_and_grow():
    idx = TPAR.ShardedKnnIndex(TPAR.make_mesh(CPU8, tp=1), dimensions=8,
                               reserved_space=64)
    rng = np.random.default_rng(1)
    vecs = {f"k{i}": rng.normal(size=8) for i in range(100)}
    for k_, v in vecs.items():
        idx.add(k_, v)
    assert idx.search(np.stack([vecs["k7"]]), k=1)[0][0][0] == "k7"
    idx.remove("k7")
    assert idx.search(np.stack([vecs["k7"]]), k=1)[0][0][0] != "k7"
    rows = idx.shard_rows
    for i in range(100, 1200):  # growth keeps old entries findable
        idx.add(f"k{i}", rng.normal(size=8))
    assert idx.shard_rows > rows
    assert idx.search(np.stack([vecs["k42"]]), k=1)[0][0][0] == "k42"
    assert len(idx) == 1199


def test_sharded_topk_merge_matches_jax():
    dp = 8
    rows = 8 * dp
    corpus = np.random.default_rng(2).normal(size=(rows, 4)).astype(np.float32)
    cj = jnp.asarray(corpus, jnp.bfloat16)
    queries = np.asarray(cj[5:7], np.float32)
    valid = np.ones((rows,), bool)
    valid[[3, 40]] = False
    sc_j, ix_j = JPAR.sharded_topk_merge(JPAR.make_mesh(tp=1), cj, jnp.asarray(valid),
                                         jnp.asarray(queries), k=3, metric="cos")
    sc_t, ix_t = TPAR.sharded_topk_merge(
        TPAR.make_mesh(CPU8, tp=1), torch.from_numpy(corpus).to(torch.bfloat16),
        torch.from_numpy(valid), torch.from_numpy(queries), k=3, metric="cos")
    assert tuple(sc_t.shape) == (2, 3) and tuple(ix_t.shape) == (2, 3)
    np.testing.assert_array_equal(ix_t.numpy(), np.asarray(ix_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-5, atol=1e-5)


def test_sharded_ivf_full_probe_is_exact_and_matches_jax(knn_data):
    vecs, q = knn_data
    t_idx = TPAR.ShardedIvfIndex(TPAR.make_mesh(CPU8, tp=1), dimensions=16,
                                 n_cells=4, nprobe=4, cell_capacity=32)
    j_idx = JPAR.ShardedIvfIndex(JPAR.make_mesh(tp=1), dimensions=16,
                                 n_cells=4, nprobe=4, cell_capacity=32)
    keys = [f"k{i}" for i in range(256)]
    t_idx.add(keys, vecs)
    j_idx.add(keys, vecs)
    got, want = t_idx.search(q, k=5), j_idx.search(q, k=5)
    for r, expect in enumerate(_numpy_top(vecs, q, 5)):
        assert _keys(got[r]) == expect == _keys(want[r])


def test_sharded_ivf_topk_merge_matches_jax():
    rng = np.random.default_rng(4)
    dp, C, cap, d = 8, 4, 16, 8
    cells = rng.normal(size=(dp * C, cap, d)).astype(np.float32)
    valid = rng.random((dp * C, cap)) > 0.2
    cents = rng.normal(size=(dp * C, d)).astype(np.float32)
    q = rng.normal(size=(4, d)).astype(np.float32)
    cj = jnp.asarray(cells, jnp.bfloat16)
    sc_j, g_j = JPAR.sharded_ivf_topk_merge(
        JPAR.make_mesh(tp=1), cj, jnp.asarray(valid), jnp.asarray(cents),
        jnp.asarray(q), 6, 2)
    sc_t, g_t = TPAR.sharded_ivf_topk_merge(
        TPAR.make_mesh(CPU8, tp=1), torch.from_numpy(cells).to(torch.bfloat16),
        torch.from_numpy(valid), torch.from_numpy(cents), torch.from_numpy(q), 6, 2)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-5, atol=1e-5)


def test_sharded_ivf_pruned_recall_reasonable():
    dim, n = 16, 2048
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(32, dim)) * 4
    vecs = centers[rng.integers(0, 32, n)] + rng.normal(size=(n, dim))
    idx = TPAR.ShardedIvfIndex(TPAR.make_mesh(CPU8, tp=1), dimensions=dim,
                               n_cells=8, nprobe=4, cell_capacity=64, train_after=32)
    idx.add([f"k{i}" for i in range(n)], vecs)
    assert idx._trained
    nq = 16
    q = centers[rng.integers(0, 32, nq)] + rng.normal(size=(nq, dim))
    res = idx.search(q, k=10)
    hits = sum(len(e & _keys(res[r])) for r, e in enumerate(_numpy_top(vecs, q, 10)))
    assert hits / (nq * 10) >= 0.8, hits


def test_sharded_ivf_remove_upsert_and_bulk():
    idx = TPAR.ShardedIvfIndex(TPAR.make_mesh(CPU8, tp=1), dimensions=8,
                               n_cells=2, nprobe=2, cell_capacity=16)
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(32, 8))
    idx.add([f"k{i}" for i in range(32)], vecs)
    idx.remove(["k0", "k1"])
    assert len(idx) == 30
    assert all(key not in ("k0", "k1") for key, _ in idx.search(vecs[0][None, :], k=5)[0])
    idx.add(["k2"], -vecs[2][None, :])  # upsert moves the key
    assert idx.search(-vecs[2][None, :], k=1)[0][0][0] == "k2"
    bulk = TPAR.ShardedIvfIndex(TPAR.make_mesh(CPU8, tp=1), dimensions=8,
                                n_cells=2, nprobe=2, cell_capacity=16)
    more = rng.normal(size=(200, 8))
    bulk.add_bulk([f"b{i}" for i in range(200)], more)
    assert len(bulk) == 200 and max(bulk._shard_count) - min(bulk._shard_count) <= 1
    assert bulk.search(more[17][None, :], k=1)[0][0][0] == "b17"


def test_ring_attention_core_vs_softmax_and_jax():
    """The ring core alone against plain softmax attention and JAX's ring
    core, including a fully padded tail shard."""
    B, nh, S, hd, n = 2, 2, 64, 8, 8
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, nh, S, hd)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), np.int32)
    mask[0, 40:] = 0  # the last 24 kv positions: the final shard all pad
    scores = np.einsum("bnqd,bnkd->bnqk", q, k) / np.sqrt(hd)
    scores = scores + np.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    ref = np.einsum("bnqk,bnkd->bnqd", p / p.sum(-1, keepdims=True), v)
    jmesh = JMesh(np.array(jax.devices()[:n]), ("sp",))
    want = compat_shard_map(
        lambda q_, k_, v_, m_: JPAR.ring_attention_core(q_, k_, v_, m_, "sp", n),
        mesh=jmesh, in_specs=(JP(None, None, "sp", None),) * 3 + (JP(None, "sp"),),
        out_specs=JP(None, None, "sp", None), check_vma=False,
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    sl = S // n

    def shards(a, axis):
        return [torch.from_numpy(np.ascontiguousarray(x)) for x in np.split(a, n, axis=axis)]

    got = TPAR.ring_attention_core(shards(q, 2), shards(k, 2), shards(v, 2), shards(mask, 1))
    got = torch.cat(got, dim=2).numpy()
    assert got.shape == (B, nh, n * sl, hd)
    assert np.abs(got - ref).max() < 1e-5
    assert np.abs(got - np.asarray(want)).max() < 1e-5


def test_ring_attention_matches_dense_and_jax():
    """Sequence-parallel encode over 8 shards against the port's encode and
    JAX's ``encode_sequence_parallel`` on the same params (f32, live
    positions, atol 1e-4 as JAX's own test)."""
    jcfg = JT.TransformerConfig(vocab_size=100, hidden=64, layers=2, heads=4,
                                intermediate=128, max_position=64, dtype=jnp.float32)
    tcfg = TT.TransformerConfig(vocab_size=100, hidden=64, layers=2, heads=4,
                                intermediate=128, max_position=64, dtype=torch.float32)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams))
    B, S = 2, 32
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 100, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[0, 28:] = 0
    want = np.asarray(JPAR.encode_sequence_parallel(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
        JMesh(np.array(jax.devices()[:8]), ("sp",)), "sp"))
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    got = TPAR.encode_sequence_parallel(tparams, tids, tmask, tcfg,
                                        Mesh(CPU8, (8,), ("sp",)), "sp").numpy()
    dense = TT.encode(tparams, tids, tmask, tcfg).numpy()
    live = np.broadcast_to(mask[:, :, None].astype(bool), got.shape)
    assert np.abs(got - dense)[live].max() < 1e-4
    assert np.abs(got - want)[live].max() < 1e-4
    with pytest.raises(ValueError, match="divisible"):
        TPAR.encode_sequence_parallel(tparams, tids[:, :30], tmask[:, :30], tcfg,
                                      Mesh(CPU8, (8,), ("sp",)), "sp")
