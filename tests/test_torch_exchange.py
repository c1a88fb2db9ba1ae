"""The port's row exchange (``engine/exchange.py``) in one process: the
peer mesh, ``control_allgather`` and broadcast over threads, the wire form
of a tensor cell (CPU numpy out, a tensor on the same device back),
bounded connects; ``EngineConfig``'s validation (the counterpart of
``tests/test_misc_final_matrix.py``'s config case); the splice pass against
JAX's, program by program and operator class by class, its undoing, and
fusion planned after it; and, end to end in two processes, tensor vectors
crossing the exchange into every process's index. Every wait is bounded."""

from __future__ import annotations

import json
import pickle
import threading

import numpy as np
import pytest
import torch

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu_torch.engine import exchange as t_exchange
from pathway_tpu_torch.engine.batch import Batch
from tests.test_torch_multiprocess import _free_port, _net, _read, _shards, _spawn


# ---------------------------------------------- the mesh in one process
def _mesh_pair(timeout=30.0):
    """Two PeerMesh ends in this process (each constructor waits for the
    other, so they are built on two threads)."""
    for _attempt in range(3):
        port = _free_port()
        meshes, errors = [None, None], []

        def build(pid):
            try:
                meshes[pid] = t_exchange.PeerMesh(pid, 2, port, connect_timeout=timeout)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        threads = [threading.Thread(target=build, args=(p,)) for p in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout + 5)
        if not errors and all(m is not None for m in meshes):
            return [t_exchange.ExchangeContext(m, timeout=timeout) for m in meshes]
        for m in meshes:
            if m is not None:
                m.close()
    raise AssertionError(f"no mesh: {errors}")


def _both_ends(fn):
    """Run ``fn(ctx)`` on both ends at once; their results."""
    ctxs = _mesh_pair()
    out, errors = [None, None], []

    def run(i):
        try:
            out[i] = fn(ctxs[i])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    try:
        assert not errors, errors
        assert not any(th.is_alive() for th in threads)
        return out, ctxs
    finally:
        for c in ctxs:
            c.close()


def _batch(keys, **cols):
    return Batch(np.asarray(keys, dtype=np.uint64),
                 {n: np.asarray(v, dtype=object) if not isinstance(v, np.ndarray) else v
                  for n, v in cols.items()})


def test_mesh_control_allgather_and_rounds():
    def fn(ctx):
        got = [ctx.control_allgather(r, (ctx.process_id, r)) for r in range(5)]
        return got, ctx.counters()["control_rounds"]

    (a, b), _ = _both_ends(fn)
    for r in range(5):
        assert a[0][r] == b[0][r] == {0: (0, r), 1: (1, r)}
    assert a[1] == b[1] == 5


def test_mesh_exchange_routes_and_broadcasts():
    def fn(ctx):
        me, peer = ctx.process_id, 1 - ctx.process_id
        out = _batch([10 + me], v=[f"from{me}"])
        routed = ctx.exchange(0, 2, {peer: out})
        empty = ctx.exchange(0, 4, {})
        bcast = ctx.exchange(1, 2, {}, broadcast=_batch([20 + me, 30 + me], v=["a", "b"]))
        return routed, empty, bcast, ctx.counters()

    (a, b), _ = _both_ends(fn)
    for me, (routed, empty, bcast, counters) in enumerate((a, b)):
        peer = 1 - me
        assert len(routed) == 1 and routed[0].keys.tolist() == [10 + peer]
        assert routed[0].cols["v"].tolist() == [f"from{peer}"]
        assert empty == []
        assert bcast[0].keys.tolist() == [20 + peer, 30 + peer]
        assert counters["bytes_sent"] > 0 and counters["bytes_received"] > 0
    assert a[3]["bytes_sent"] == b[3]["bytes_received"]


def test_tensor_cells_cross_as_numpy_and_come_back_tensors():
    vec = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    half = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    col = np.empty(3, dtype=object)
    for i, v in enumerate((vec, half, "text")):
        col[i] = v
    packed = t_exchange._pack_batch(Batch(np.arange(3, dtype=np.uint64), {"c": col}))
    # on the wire: no tensor, the column itself untouched
    wire = pickle.loads(pickle.dumps(packed))
    assert not any(isinstance(v, torch.Tensor) for v in wire[1]["c"])
    assert isinstance(col[0], torch.Tensor)
    back = t_exchange._unpack_batch(wire).cols["c"]
    assert torch.equal(back[0], vec) and back[0].device == vec.device
    assert back[1].dtype == torch.bfloat16 and torch.equal(back[1], half)
    assert back[2] == "text"


def test_mesh_connect_is_bounded():
    port = _free_port()
    with pytest.raises(TimeoutError, match="peer"):
        t_exchange.PeerMesh(1, 2, port, connect_timeout=1.0)


# ------------------------------------------------------------- EngineConfig
def test_engine_config_processes_fields():
    cfg = TPW.EngineConfig(threads=3, processes=2, process_id=1, first_port=20000)
    assert (cfg.threads, cfg.processes, cfg.process_id, cfg.first_port) == (3, 2, 1, 20000)
    default = TPW.EngineConfig()
    assert (default.processes, default.process_id, default.first_port) == (1, 0, 10000)


@pytest.mark.parametrize("kw", [
    {"processes": 0},
    {"processes": 2, "process_id": 2},
    {"processes": 2, "process_id": -1},
    {"process_id": 1},
    {"first_port": 0},
    {"processes": 4, "first_port": 65534},
])
def test_engine_config_rejects(kw):
    with pytest.raises(ValueError):
        TPW.EngineConfig(**kw)


# ------------------------------------------------- the splice, against JAX
class _FakeMesh:
    peers = [1]


class _FakeCtx:
    """Enough of an ExchangeContext for the splice pass."""

    def __init__(self):
        self.process_id, self.processes, self.mesh = 0, 2, _FakeMesh()
        self.n, self.bases = 0, 0

    def next_exchange_id(self):
        self.n += 1
        return self.n - 1

    def next_iterate_ctl_base(self):
        self.bases += 1
        return self.bases


def _routing_program(pw):
    idx = __import__(f"{pw.__name__}.stdlib.indexing", fromlist=["x"])
    t = pw.debug.table_from_markdown("""
        k | g | v   | __time__
        a | 1 | 1.0 | 2
        b | 2 | 2.0 | 2
        c | 1 | 3.0 | 4
        """)
    g = t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))
    j = t.join(g, t.g == g.g).select(t.k, g.s)
    ix = t.select(t.k, p=g.pointer_from(t.g))
    looked = ix.select(ix.k, s=g.ix(ix.p).s)
    vec = t.select(t.k, vec=pw.apply(lambda v: [v, 1.0], t.v))
    kw = {"device": "cpu"} if pw is TPW else {}
    res = idx.DataIndex(vec, idx.BruteForceKnn(vec.vec, dimensions=2, **kw)).query_as_of_now(
        vec.vec, number_of_matches=1)
    w = t.windowby(t.v, window=pw.temporal.tumbling(duration=2.0)).reduce(
        n=pw.reducers.count())
    srt = t.sort(t.v)
    it = pw.iterate(lambda t: t.select(k=t.k, v=pw.if_else(t.v < 3.0, t.v + 1.0, t.v)), t=t)
    gb = t._gradual_broadcast(g, g.s, g.s, g.s)
    return [j, looked, res, w, srt, it, gb, t.deduplicate(value=t.v, acceptor=lambda new, old: new > old)]


def _routings(pw, mod):
    pw.clear_graph()
    tables = _routing_program(pw)
    capture = __import__(f"{pw.__name__}.engine.operators.output", fromlist=["x"]).CaptureNode
    graph = pw.G.engine_graph
    targets = [capture(graph, tab._node) for tab in tables]
    spliced = mod.splice_exchanges(graph, graph.topo_order(targets), _FakeCtx())
    out = []
    for node, i, _orig in spliced:
        if i == -1:
            out.append((node.name, "iterate ctx"))
        else:
            out.append((node.name, i, repr(node.inputs[i].routing)))
    stateful = sorted((n.name, n.is_stateful()) for n in graph.topo_order(targets)
                      if not isinstance(n, mod.ExchangeNode))
    mod.unsplice_exchanges(spliced)
    pw.clear_graph()
    return out, stateful


def test_splice_routes_each_operator_as_jax():
    from pathway_tpu.engine import exchange as j_exchange

    j_routes, j_stateful = _routings(JPW, j_exchange)
    t_routes, t_stateful = _routings(TPW, t_exchange)
    assert t_routes == j_routes
    assert t_stateful == j_stateful
    names = {r[0] for r in t_routes}
    for op in ("Groupby", "Join", "ExternalIndex", "Iterate"):
        assert any(n.startswith(op) for n in names), (op, names)


_OPERATOR_MODULES = ("core", "reduce", "join", "temporal", "instance_recompute", "asof_now",
                     "sorted_index", "external_index", "output", "gradual_broadcast")


def _node_classes(pkg_name):
    import importlib
    import inspect

    graph = importlib.import_module(f"{pkg_name}.engine.graph")
    mods = [importlib.import_module(f"{pkg_name}.engine.operators.{m}") for m in _OPERATOR_MODULES]
    mods.append(importlib.import_module(f"{pkg_name}.internals.iterate"))
    out = {}
    for mod in mods:
        for name, cls in vars(mod).items():
            if inspect.isclass(cls) and issubclass(cls, graph.Node) and cls.__module__ == mod.__name__:
                out[name] = cls
    return out, graph.Node


def test_every_operator_class_is_stateful_as_jax():
    """Class by class over the operator modules both packages have: the
    port's statefulness (a ``reset`` of its own, not an output-side node,
    or an ``is_stateful`` of its own) is JAX's, so the splice routes the
    same operators."""
    j_classes, j_node = _node_classes("pathway_tpu")
    t_classes, t_node = _node_classes("pathway_tpu_torch")
    assert set(t_classes) <= set(j_classes)
    for name in sorted(t_classes):
        j, t = j_classes[name], t_classes[name]
        j_state = j.reset is not j_node.reset and not getattr(j, "_persist_exempt", False)
        t_state = t.reset is not t_node.reset and not t._output_side
        assert t_state == j_state, name
        assert (t.is_stateful is not t_node.is_stateful) == (
            j.is_stateful is not j_node.is_stateful), name
        assert bool(getattr(t, "always_step", False) is True) == bool(
            getattr(j, "always_step", False) is True), name


def _temporal_program(pw):
    """The temporal nodes, the sorted index and the rest of the operators
    PR 13-16 added, for the splice test."""
    sorting = __import__(f"{pw.__name__}.stdlib.indexing.sorting", fromlist=["x"])
    t = pw.debug.table_from_markdown("""
        k | g | v   | __time__
        a | 1 | 1.0 | 2
        b | 2 | 2.0 | 2
        c | 1 | 3.0 | 4
        """)
    q = pw.debug.table_from_markdown("""
        k | g | v   | __time__
        x | 1 | 2.5 | 4
        """)
    w = t.windowby(t.v, window=pw.temporal.sliding(hop=1.0, duration=2.0),
                   behavior=pw.temporal.common_behavior(delay=1.0, cutoff=2.0)).reduce(
        n=pw.reducers.count())
    ij = pw.temporal.interval_join(q, t, q.v, t.v, pw.temporal.interval(-1.0, 1.0)).select(
        a=pw.left.k, b=pw.right.k)
    aj = pw.temporal.asof_join(q, t, q.v, t.v, q.g == t.g).select(a=pw.left.k, b=pw.right.k)
    an = q.asof_now_join(t, q.g == t.g).select(a=pw.left.k, b=pw.right.k)
    keyed = t.select(key=t.v, instance=t.g)
    idx = sorting.build_sorted_index(keyed)
    flat = t.select(parts=pw.apply_with_type(lambda v: (v, v), tuple, t.v)).flatten(pw.this.parts)
    cat = t.select(t.k).concat_reindex(q.select(q.k))
    upd = t.update_rows(t.select(t.k, t.g, v=t.v + 1.0))
    return [w, ij, aj, an, idx["index"], flat, cat, upd, t.diff(t.v, t.v)]


def test_splice_routes_the_temporal_operators_as_jax():
    from pathway_tpu.engine import exchange as j_exchange

    def routes(pw, mod):
        pw.clear_graph()
        tables = _temporal_program(pw)
        capture = __import__(f"{pw.__name__}.engine.operators.output",
                             fromlist=["x"]).CaptureNode
        graph = pw.G.engine_graph
        targets = [capture(graph, tab._node) for tab in tables]
        spliced = mod.splice_exchanges(graph, graph.topo_order(targets), _FakeCtx())
        out = [(node.name, i, repr(node.inputs[i].routing)) for node, i, _ in spliced]
        mod.unsplice_exchanges(spliced)
        pw.clear_graph()
        return out

    t_routes = routes(TPW, t_exchange)
    assert t_routes == routes(JPW, j_exchange)
    names = {r[0] for r in t_routes}
    for op in ("Buffer", "Freeze", "AsofJoin", "IntervalJoin", "Join", "Sort", "BuildSortedIndex",
               "Concat", "UpdateRows"):
        assert any(op in n for n in names), (op, names)


TENSOR_KNN = """
import json, torch
from importlib import import_module
idx = import_module("pathway_tpu_torch.stdlib.indexing")

class D(pw.Schema):
    doc: int
    vec: list

docs = pw.io.jsonlines.read("docs", schema=D, mode="static")
tvecs = docs.select(docs.doc, vec=pw.apply(lambda v: torch.tensor(v, dtype=torch.float32),
                                           docs.vec))
index = idx.DataIndex(tvecs, idx.BruteForceKnn(tvecs.vec, dimensions=8, metric="cos",
                                               device="cpu"))
total = tvecs.reduce(n=pw.reducers.count())
ready = tvecs.filter(total.ix_ref().n == 20)
res = index.query(ready.vec, number_of_matches=3, with_distances=True)
res = res.select(q=ready.restrict(res).doc, docs=res.doc, dist=res._pw_dist)
pw.io.jsonlines.write(res, "out.jsonl")
node = next(n for n in pw.G.engine_graph.nodes if type(n).__name__ == "ExternalIndexNode")
pw.run(**RUN)
with open(f"index.{PID}.json", "w") as fh:
    json.dump(sorted(int(k) for k in node._index._keys), fh)
"""


def test_tensor_vectors_cross_the_exchange_into_every_index(tmp_path):
    """A UDF that returns CPU tensors feeds the index through the
    broadcast: every process's index holds the one-process rows, and the
    replies equal the one-process run's."""
    rng = np.random.default_rng(3)
    data = tmp_path / "docs"
    data.mkdir()
    for i in range(20):
        (data / f"d{i}.jsonl").write_text(
            json.dumps({"doc": i, "vec": rng.normal(size=8).tolist()}) + "\n")
    arms = {}
    for n in (1, 2):
        d = tmp_path / f"p{n}"
        d.mkdir()
        (d / "docs").symlink_to(data)
        arms[n] = d
    # the one-process run meanwhile: nothing here is timed
    one_proc = threading.Thread(target=_spawn, args=(TENSOR_KNN, arms[1]),
                                kwargs={"processes": 1})
    one_proc.start()
    _spawn(TENSOR_KNN, arms[2], processes=2)
    one_proc.join(120)
    one = json.loads((arms[1] / "index.0.json").read_text())
    assert len(one) == 20
    for pid in range(2):
        assert json.loads((arms[2] / f"index.{pid}.json").read_text()) == one

    def replies(rows):
        return {k: (v[0], tuple(round(x, 5) for x in v[1]))
                for k, v in _net(rows, ["q"], ["docs", "dist"]).items()}

    want = replies(_read(arms[1] / "out.jsonl"))
    assert len(want) == 20
    assert replies(_shards(arms[2], "out.jsonl")) == want


def test_unsplice_restores_the_graph():
    TPW.clear_graph()
    tables = _routing_program(TPW)
    from pathway_tpu_torch.engine.operators.output import CaptureNode

    graph = TPW.G.engine_graph
    targets = [CaptureNode(graph, tab._node) for tab in tables]
    before = [(n.id, [i.id for i in n.inputs]) for n in graph.nodes]
    spliced = t_exchange.splice_exchanges(graph, graph.topo_order(targets), _FakeCtx())
    assert spliced
    t_exchange.unsplice_exchanges(spliced)
    assert [(n.id, [i.id for i in n.inputs]) for n in graph.nodes] == before
    TPW.clear_graph()


def test_fusion_is_planned_after_the_splice():
    """A chain of stateless operators around a stateful one: the fused
    chains never hold an ExchangeNode, and the exchange sits right before
    the stateful operator in the plan."""
    from pathway_tpu_torch.engine.operators.output import CaptureNode
    from pathway_tpu_torch.engine.scheduler import Scheduler

    TPW.clear_graph()
    t = TPW.debug.table_from_markdown("""
        g | v
        1 | 1
        2 | 2
        """)
    a = t.select(t.g, w=t.v + 1).filter(pw_this_w := TPW.this.w > 0).select(TPW.this.g,
                                                                             TPW.this.w)
    del pw_this_w
    r = a.groupby(a.g).reduce(a.g, s=TPW.reducers.sum(a.w))
    out = r.select(r.g, s2=r.s * 2).filter(TPW.this.s2 > 0)
    cap = CaptureNode(TPW.G.engine_graph, out._node)
    sched = Scheduler(TPW.G.engine_graph, [cap], config=TPW.EngineConfig(),
                      exchange_ctx=_FakeCtx())
    assert sched.fused_chains
    for chain in sched.fused_chains:
        assert not any(isinstance(m, t_exchange.ExchangeNode) for m in chain)
    names = [n.name for n in sched.order]
    assert names.index("Exchange->Groupby") + 1 == names.index("Groupby")
    t_exchange.unsplice_exchanges(sched._spliced)
    TPW.clear_graph()
