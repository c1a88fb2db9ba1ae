"""Several processes on the CPU: the port's TCP row exchange
(``engine/exchange.py``) behind ``EngineConfig(processes=2)``.

Each case of ``tests/test_multiprocess.py`` but the persistence one runs
as two port processes (each a fresh interpreter, given its process id and
the mesh's first port on its command line), and the folded final state of
their output shards is held against the JAX package running the same
program in one process (in this test process, meanwhile). Beside them: an
upsert source sharded by key, a Python connector and a static table fed
on process 0 only, a deferred UDF draining under the lockstep loop, and
``chip_smoke.py`` phase 20's program at 512 docs with the small test
encoder, in one process and in two, against JAX and a host union-find /
Dijkstra. The exchange's own pieces are in ``tests/test_torch_exchange.py``.
Every wait is bounded."""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

import pathway_tpu as JPW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120

# what a launcher's child does: build its EngineConfig from what it was given
HEADER = """
import sys
import pathway_tpu_torch as pw
PID, N, PORT, THREADS = map(int, sys.argv[1:5])
RUN = {"config": pw.EngineConfig(processes=N, process_id=PID, first_port=PORT,
                                 threads=THREADS)}
KNN = {"device": "cpu"}
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(src: str, cwd, processes: int, threads: int):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", src, str(pid), str(processes), str(port), str(threads)],
        cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(processes)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _spawn(script: str, cwd, processes: int = 2, threads: int = 1, tries: int = 3,
           meanwhile=None):
    """Run ``script`` as ``processes`` port processes; every one must exit
    0. ``meanwhile()`` runs here while they do. A port range that another
    process took between the probe and the bind (``EADDRINUSE``) is
    retried with a fresh one."""
    src = HEADER + textwrap.dedent(script)
    for attempt in range(tries):
        procs = _start(src, cwd, processes, threads)
        if meanwhile is not None:
            try:
                meanwhile()
            finally:
                meanwhile = None
        outs = _wait(procs)
        if attempt + 1 < tries and any(
                rc != 0 and "Address already in use" in err for rc, _o, err in outs):
            continue
        for rc, out, err in outs:
            assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-4000:]}"
        return outs
    raise AssertionError("unreachable")


def _jax_run(script: str, cwd, monkeypatch):
    """The same program through the JAX package, one process, here."""
    monkeypatch.chdir(cwd)
    JPW.clear_graph()
    try:
        exec(textwrap.dedent(script), {"pw": JPW, "RUN": {}, "PID": 0, "KNN": {}})
    finally:
        JPW.clear_graph()


def _both_runs(script, arms, monkeypatch, threads=1):
    """Two port processes in ``arms["port"]`` and, meanwhile, the JAX
    package in one process in ``arms["jax"]``."""
    _spawn(script, arms["port"], threads=threads,
           meanwhile=lambda: _jax_run(script, arms["jax"], monkeypatch))


def _read(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _shards(cwd, name, processes=2):
    return [r for p in range(processes) for r in _read(os.path.join(cwd, f"{name}.{p}"))]


def _arms(tmp_path, data_dirs: dict):
    """A ``port`` and a ``jax`` directory, each holding links to the inputs."""
    out = {}
    for arm in ("port", "jax"):
        d = tmp_path / arm
        d.mkdir()
        for name, src in data_dirs.items():
            (d / name).symlink_to(src)
        out[arm] = d
    return out


def _net(rows, key_cols, val_cols):
    """Fold an update stream to {key: values} of the rows alive at its end;
    a key with several live rows means a lost retraction."""
    def frozen(x):
        return tuple(frozen(y) for y in x) if isinstance(x, list) else x

    net: dict = {}
    for r in rows:
        k = (tuple(r[c] for c in key_cols), tuple(frozen(r[c]) for c in val_cols))
        net[k] = net.get(k, 0) + r["diff"]
    out: dict = {}
    for (k, v), c in net.items():
        if c:
            assert c == 1 and k not in out, f"{k}: live rows {out.get(k)}, {v} (count {c})"
            out[k] = v
    return out


# ------------------------------------------------ tests/test_multiprocess.py
WORDCOUNT = """
class S(pw.Schema):
    word: str

t = pw.io.jsonlines.read("in", schema=S, mode="static")
counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, "out.jsonl")
pw.run(**RUN)
"""


def test_two_process_wordcount(tmp_path, monkeypatch):
    data = tmp_path / "data"
    data.mkdir()
    words = ["alpha", "beta", "gamma", "delta"]
    for i in range(8):
        lines = [words[(i + j) % 4] for j in range(i + 1)]
        (data / f"f{i}.jsonl").write_text("".join(json.dumps({"word": w}) + "\n" for w in lines))
    arms = _arms(tmp_path, {"in": data})
    _both_runs(WORDCOUNT, arms, monkeypatch)
    got = _net(_shards(arms["port"], "out.jsonl"), ["word"], ["c"])
    want = _net(_read(arms["jax"] / "out.jsonl"), ["word"], ["c"])
    assert got == want and len(got) == 4
    # each word's rows live on exactly one process (sharded state)
    owners: dict = {}
    for pid in range(2):
        for r in _read(arms["port"] / f"out.jsonl.{pid}"):
            owners.setdefault(r["word"], set()).add(pid)
    assert all(len(p) == 1 for p in owners.values()), owners


SOAK = """
class Orders(pw.Schema):
    uid: int
    amount: int

class Users(pw.Schema):
    uid: int
    tier: str

orders = pw.io.jsonlines.read("in/orders", schema=Orders, mode="static")
users = pw.io.jsonlines.read("in/users", schema=Users, mode="static")
j = orders.join(users, orders.uid == users.uid).select(orders.amount, users.tier)
per_tier = j.groupby(j.tier).reduce(j.tier, total=pw.reducers.sum(j.amount),
                                    n=pw.reducers.count())
pw.io.jsonlines.write(per_tier, "out.jsonl")
pw.run(**RUN)
"""


def test_two_process_exchange_soak(tmp_path, monkeypatch):
    """A groupby and a join both reshuffle 120k rows across the mesh: net
    results equal the one-process JAX run."""
    rng = np.random.default_rng(5)
    n_rows, n_users, n_files = 120_000, 500, 6
    data = tmp_path / "data"
    (data / "orders").mkdir(parents=True)
    (data / "users").mkdir()
    uids = rng.integers(0, n_users, n_rows)
    amounts = rng.integers(1, 100, n_rows)
    per = n_rows // n_files
    for fi in range(n_files):
        sl = slice(fi * per, (fi + 1) * per)
        (data / "orders" / f"f{fi}.jsonl").write_text("".join(
            '{"uid": %d, "amount": %d}\n' % (u, a)
            for u, a in zip(uids[sl].tolist(), amounts[sl].tolist())))
    (data / "users" / "users.jsonl").write_text("".join(
        '{"uid": %d, "tier": "t%d"}\n' % (u, u % 7) for u in range(n_users)))
    arms = _arms(tmp_path, {"in": data})
    _both_runs(SOAK, arms, monkeypatch)
    got = _net(_shards(arms["port"], "out.jsonl"), ["tier"], ["total", "n"])
    want = _net(_read(arms["jax"] / "out.jsonl"), ["tier"], ["total", "n"])
    assert got == want
    assert sum(n for _t, n in got.values()) == n_rows and len(got) == 7


JOIN = """
class L(pw.Schema):
    k: str
    x: int

class R(pw.Schema):
    k: str
    y: int

lt = pw.io.jsonlines.read("left", schema=L, mode="static")
rt = pw.io.jsonlines.read("right", schema=R, mode="static")
j = lt.join(rt, lt.k == rt.k).select(lt.k, lt.x, rt.y)
pw.io.jsonlines.write(j, "out.jsonl")
pw.run(**RUN)
"""


def test_two_process_join(tmp_path, monkeypatch):
    data_l, data_r = tmp_path / "left", tmp_path / "right"
    data_l.mkdir()
    data_r.mkdir()
    for i in range(6):
        (data_l / f"l{i}.jsonl").write_text(json.dumps({"k": f"key{i}", "x": i}) + "\n")
        (data_r / f"zz_other_{i}.jsonl").write_text(
            json.dumps({"k": f"key{i}", "y": i * 10}) + "\n")
    arms = _arms(tmp_path, {"left": data_l, "right": data_r})
    _both_runs(JOIN, arms, monkeypatch)
    got = _net(_shards(arms["port"], "out.jsonl"), ["k"], ["x", "y"])
    assert got == _net(_read(arms["jax"] / "out.jsonl"), ["k"], ["x", "y"])
    assert len(got) == 6 and all(y == x * 10 for x, y in got.values())


STREAMING = """
import json, threading, time

class S(pw.Schema):
    word: str

t = pw.io.jsonlines.read("in", schema=S, mode="streaming")
counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, "out.jsonl")
connectors = list(pw.G.connectors)

def feeder():
    time.sleep(1.0)
    if PID == 0:
        with open("late/late1.jsonl", "w") as f:
            f.write(json.dumps({"word": "alpha"}) + "\\n")
            f.write(json.dumps({"word": "gamma"}) + "\\n")
    time.sleep(2.0)
    for c in connectors:
        c._stop.set()
        c.close()

threading.Thread(target=feeder, daemon=True).start()
pw.run(**RUN)
"""


def test_two_process_streaming_updates(tmp_path, monkeypatch):
    """Files appear over time; counts stay right across exchanged updates."""
    for arm in ("port", "jax"):
        d = tmp_path / arm / "in"
        d.mkdir(parents=True)
        (d / "seed0.jsonl").write_text(
            json.dumps({"word": "alpha"}) + "\n" + json.dumps({"word": "beta"}) + "\n")
        (tmp_path / arm / "late").symlink_to(d)
    _both_runs(STREAMING, {"port": tmp_path / "port", "jax": tmp_path / "jax"}, monkeypatch)
    got = _net(_shards(tmp_path / "port", "out.jsonl"), ["word"], ["c"])
    want = _net(_read(tmp_path / "jax" / "out.jsonl"), ["word"], ["c"])
    assert got == want == {("alpha",): (2,), ("beta",): (1,), ("gamma",): (1,)}


KNN_PROGRAM = """
import os, shutil, threading, time
from importlib import import_module
idx = import_module(pw.__name__ + ".stdlib.indexing")

class D(pw.Schema):
    doc: str
    vec: list

class Q(pw.Schema):
    qid: str
    qvec: list

docs = pw.io.jsonlines.read("docs", schema=D, mode="streaming")
qs = pw.io.jsonlines.read("qs", schema=Q, mode="streaming")
index = idx.DataIndex(docs, idx.BruteForceKnn(docs.vec, dimensions=8, **KNN))
res = index.query_as_of_now(qs.qvec, number_of_matches=1).select(pw.this.doc)
joined = qs.join(res, qs.id == res.id, id=qs.id).select(qs.qid, hit=res.doc)
pw.io.jsonlines.write(joined, "out.jsonl")
connectors = list(pw.G.connectors)

def feeder():
    time.sleep(1.5)  # every doc file ingested and broadcast by now
    if PID == 0:
        for f in sorted(os.listdir("staged")):
            shutil.move(os.path.join("staged", f), os.path.join("qs", f))
    time.sleep(1.5)
    for c in connectors:
        c._stop.set()
        c.close()

threading.Thread(target=feeder, daemon=True).start()
pw.run(**RUN)
"""


def test_two_process_knn_sees_full_corpus(tmp_path, monkeypatch):
    """Index additions are broadcast: a query owned by either process finds
    the nearest doc whichever process read its file."""
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(20, 8))
    data = tmp_path / "docs"
    data.mkdir()
    for i in range(20):
        (data / f"doc{i}.jsonl").write_text(
            json.dumps({"doc": f"d{i}", "vec": vecs[i].tolist()}) + "\n")
    for arm in ("port", "jax"):
        (tmp_path / arm).mkdir()
        (tmp_path / arm / "docs").symlink_to(data)
        (tmp_path / arm / "qs").mkdir()
        staged = tmp_path / arm / "staged"
        staged.mkdir()
        for i, qi in enumerate((3, 7, 11, 16)):
            (staged / f"q{i}.jsonl").write_text(
                json.dumps({"qid": f"q{qi}", "qvec": (vecs[qi] + 1e-3).tolist()}) + "\n")
    _both_runs(KNN_PROGRAM, {"port": tmp_path / "port", "jax": tmp_path / "jax"}, monkeypatch)

    def hits(rows):
        out = {}
        for r in rows:
            if r["diff"] > 0:
                h = r["hit"]
                out[r["qid"]] = h[0] if isinstance(h, (list, tuple)) else h
        return out

    got = hits(_shards(tmp_path / "port", "out.jsonl"))
    assert got == hits(_read(tmp_path / "jax" / "out.jsonl"))
    assert got == {f"q{i}": f"d{i}" for i in (3, 7, 11, 16)}


RELAX = """
class E(pw.Schema):
    u: int
    v: int
    w: float

edges = pw.io.jsonlines.read("edges", schema=E, mode="static")
verts = edges.select(n=edges.u).concat_reindex(edges.select(n=edges.v))
dist0 = verts.groupby(verts.n).reduce(verts.n, d=pw.if_else(verts.n == 0, 0.0, 1e18))

def relax(dist, edges):
    cand = dist.join(edges, dist.n == edges.u).select(n=edges.v, d=dist.d + edges.w)
    both = dist.select(dist.n, dist.d).concat_reindex(cand)
    nd = both.groupby(both.n).reduce(both.n, d=pw.reducers.min(both.d))
    return dict(dist=nd, edges=edges)

res = pw.iterate(relax, dist=dist0, edges=edges)
out = res.dist
pw.io.jsonlines.write(out.filter(out.d < 1e17), "dists.jsonl")
EXTRA
pw.run(monitoring_level=pw.MonitoringLevel.NONE, **RUN)
"""


def _edges_dir(tmp_path, edges):
    data = tmp_path / "edges"
    data.mkdir()
    for i, (u, v, w) in enumerate(edges):
        (data / f"e{i}.jsonl").write_text(json.dumps({"u": u, "v": v, "w": w}) + "\n")
    return _arms(tmp_path, {"edges": data})


def _dists(rows):
    return {k[0]: v[0] for k, v in _net(rows, ["n"], ["d"]).items()}


@pytest.mark.parametrize("threads", [1, 2])
def test_two_process_iterate_shortest_paths(tmp_path, monkeypatch, threads):
    """pw.iterate under the mesh: relaxation rounds whose groupby and join
    span both processes converge to the one-process distances (at two
    threads too: control tags and subgraph state are per primary)."""
    arms = _edges_dir(tmp_path, [(0, 1, 1.0), (1, 2, 1.0), (2, 3, 1.0), (3, 4, 1.0),
                                 (4, 5, 1.0), (0, 3, 2.5)])
    script = RELAX.replace("EXTRA", "")
    _both_runs(script, arms, monkeypatch, threads=threads)
    got = _dists(_shards(arms["port"], "dists.jsonl"))
    assert got == _dists(_read(arms["jax"] / "dists.jsonl"))
    assert got == {0: 0.0, 1: 1.0, 2: 2.0, 3: 2.5, 4: 3.5, 5: 4.5}
    # the final row of each vertex lives on exactly one shard
    finals: dict = {}
    for pid in range(2):
        for n in _dists(_read(arms["port"] / f"dists.jsonl.{pid}")):
            finals.setdefault(n, set()).add(pid)
    assert all(len(p) == 1 for p in finals.values()), finals


def test_two_process_iterate_multi_output(tmp_path, monkeypatch):
    """One distributed fixpoint an epoch; the sibling output is complete."""
    arms = _edges_dir(tmp_path, [(0, 1, 1.0), (1, 2, 1.0), (0, 2, 5.0)])
    script = RELAX.replace("EXTRA", 'pw.io.jsonlines.write(res.edges.select(res.edges.u, '
                                    'res.edges.v), "edges_out.jsonl")')
    _both_runs(script, arms, monkeypatch)
    got = _dists(_shards(arms["port"], "dists.jsonl"))
    assert got == _dists(_read(arms["jax"] / "dists.jsonl")) == {0: 0.0, 1: 1.0, 2: 2.0}
    eo = sorted(k for k in _net(_shards(arms["port"], "edges_out.jsonl"), ["u", "v"], []))
    assert eo == sorted(k for k in _net(_read(arms["jax"] / "edges_out.jsonl"), ["u", "v"], []))
    assert eo == [(0, 1), (0, 2), (1, 2)]


DEFERRED = """
import time

class Double(pw.UDF):
    def __init__(self):
        super().__init__(deterministic=True, batch=True, max_batch_size=7,
                         executor=pw.udfs.fully_async_executor())

    def __wrapped__(self, xs):
        return [x * 2 for x in xs]

    def submit_batch(self, xs):
        return list(xs)

    def resolve_batch(self, handles):
        time.sleep(0.02)
        return [[x * 2 for x in h] for h in handles]

class S(pw.Schema):
    g: int
    x: int

t = pw.io.jsonlines.read("in", schema=S, mode="static")
d = t.select(t.g, y=Double()(t.x))
s = d.groupby(d.g).reduce(d.g, total=pw.reducers.sum(d.y), n=pw.reducers.count())
pw.io.jsonlines.write(s, "out.jsonl")
pw.run(**RUN)
"""


def test_deferred_udf_drains_under_lockstep(tmp_path, monkeypatch):
    """A deferred UDF's drain thread injects after its epoch returned: the
    in-flight flag in every control round keeps both processes looping
    until the last chunk is in, and the groupby sees every row."""
    data = tmp_path / "data"
    data.mkdir()
    for f in range(6):
        (data / f"f{f}.jsonl").write_text("".join(
            json.dumps({"g": i % 5, "x": i}) + "\n" for i in range(f * 40, f * 40 + 40)))
    arms = _arms(tmp_path, {"in": data})
    _both_runs(DEFERRED, arms, monkeypatch)
    got = _net(_shards(arms["port"], "out.jsonl"), ["g"], ["total", "n"])
    assert got == _net(_read(arms["jax"] / "out.jsonl"), ["g"], ["total", "n"])
    assert sum(n for _t, n in got.values()) == 240


UPSERT = """
class S(pw.Schema):
    k: str = pw.column_definition(primary_key=True)
    v: int

t = pw.io.jsonlines.read("in", schema=S, mode="static")
m = t.select(t.v, m=t.v % 3)
s = m.groupby(m.m).reduce(m.m, total=pw.reducers.sum(m.v), n=pw.reducers.count())
pw.io.jsonlines.write(t, "rows.jsonl")
pw.io.jsonlines.write(s, "sums.jsonl")
pw.run(**RUN)
"""


def test_two_process_upsert_source_shards_by_key(tmp_path, monkeypatch):
    """A primary-keyed source: every process scans every file and keeps
    the keys it owns, so each key's versions meet on one process."""
    data = tmp_path / "data"
    data.mkdir()
    for f in range(4):
        (data / f"f{f}.jsonl").write_text("".join(
            json.dumps({"k": f"key{i}", "v": 10 * f + i}) + "\n" for i in range(12)))
    arms = _arms(tmp_path, {"in": data})
    _both_runs(UPSERT, arms, monkeypatch)
    rows = _net(_shards(arms["port"], "rows.jsonl"), ["k"], ["v"])
    assert rows == _net(_read(arms["jax"] / "rows.jsonl"), ["k"], ["v"])
    assert len(rows) == 12
    assert _net(_shards(arms["port"], "sums.jsonl"), ["m"], ["total", "n"]) == _net(
        _read(arms["jax"] / "sums.jsonl"), ["m"], ["total", "n"])
    owners: dict = {}
    for pid in range(2):
        for r in _read(arms["port"] / f"rows.jsonl.{pid}"):
            owners.setdefault(r["k"], set()).add(pid)
    assert all(len(p) == 1 for p in owners.values()) and len(
        {min(p) for p in owners.values()}) == 2


PROCESS_ZERO = '''
class Subject(pw.io.python.ConnectorSubject):
    def run(self):
        for i in range(30):
            self.next(word=f"w{i % 4}")

class S(pw.Schema):
    word: str

live = pw.io.python.read(Subject(), schema=S)
static = pw.debug.table_from_markdown("""
    word
    w0
    w9
    """)
both = live.concat_reindex(static)
counts = both.groupby(both.word).reduce(both.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, "out.jsonl")
pw.run(**RUN)
'''


def test_two_process_python_connector_and_static_table_run_once(tmp_path, monkeypatch):
    """A connector that does not partition its input and a static table
    feed on process 0 only: no row is counted twice."""
    arms = {a: tmp_path / a for a in ("port", "jax")}
    for d in arms.values():
        d.mkdir()
    _both_runs(PROCESS_ZERO, arms, monkeypatch)
    got = _net(_shards(arms["port"], "out.jsonl"), ["word"], ["c"])
    assert got == _net(_read(arms["jax"] / "out.jsonl"), ["word"], ["c"])
    assert got == {("w0",): (9,), ("w1",): (8,), ("w2",): (7,), ("w3",): (7,), ("w9",): (1,)}


# ------------------------------- chip_smoke.py phase 20 at a small size
# 512 docs of phase 4's corpus recipe in 8 files, 16 queries; the small
# test encoder in f32 on the CPU; the graph's edge threshold for its
# embeddings (10-90% of the docs share a component at it)
SLICE_DOCS, SLICE_QUERIES, SLICE_TAU = 512, 16, 0.976


@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    import chip_smoke as cs
    from tests.torch_parity import SMALL, np_encoder_params

    tmp = tmp_path_factory.mktemp("phase20")
    docs, queries = cs.corpus(n_queries=SLICE_QUERIES)
    docs = docs[:SLICE_DOCS]
    params = tmp / "params.pkl"
    npp = np_encoder_params(seed=4)
    with open(params, "wb") as fh:
        pickle.dump(npp, fh)
    base = cs.mp_setup(str(tmp), docs, queries, SLICE_DOCS)
    base.update(dim=SMALL["hidden"], tau=SLICE_TAU, batch=128, device="cpu",
                model={"params": str(params), "cfg": dict(SMALL), "dtype": "float32",
                       "max_len": 64})
    return base, npp


def _jax_slice(base, npp):
    """Phase 20's programs through the JAX package in one process, here,
    over the same files; its outputs under ``jax-a.jsonl`` / ``jax-b``."""
    import chip_smoke as cs
    from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
    from pathway_tpu.models.tokenizer import HashTokenizer as JTok
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JSTE
    from tests.torch_parity import configs, to_jax

    jcfg, _ = configs("float32")
    model = JEmbed(jcfg, params=to_jax(npp), tokenizer=JTok(
        vocab_size=jcfg.vocab_size, max_length=64), max_length=64)
    spec = dict(base, out_a=os.path.join(base["tmp"], "jax-a.jsonl"),
                out_b=os.path.join(base["tmp"], "jax-b"))
    os.makedirs(spec["out_b"], exist_ok=True)
    try:
        for program in (cs.mp_program_a, cs.mp_program_b):
            emb = JSTE(model, max_batch_size=base["batch"], deferred=True)
            JPW.clear_graph()
            program(JPW, emb, spec, {})
            JPW.run()
            JPW.clear_graph()
    finally:
        model.close()


def test_phase20_slice_one_and_two_processes_equal_jax_and_host(slice_inputs, monkeypatch):
    import chip_smoke as cs

    base, npp = slice_inputs
    # the children encode on the CPU: keep each one's thread pool small so
    # that three of them and this process do not oversubscribe the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    # the one-process arm, the two-process arm and JAX (in this process)
    # run at once: on the CPU nothing here is timed
    runs, errors = {}, []

    def arm(n, tag):
        try:
            runs[tag] = (n, cs.mp_arm(base, n, "ab", tag))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=arm, args=a) for a in ((1, "p1r0"), (2, "p2r0"))]
    for th in threads:
        th.start()
    _jax_slice(base, npp)
    for th in threads:
        th.join(2 * cs.MP_TIMEOUT)
    assert not errors, errors
    runs = {tag: runs[tag] for tag in ("p1r0", "p2r0")}
    # every bar of the chip phase: disjoint shares, full indexes, each query
    # answered once, top-10 equal across arms, the graph against the host
    report = cs.mp_check(base, runs)
    two = report["p2r0"]
    assert all(d > 0 for d in two["docs"]) and sum(two["docs"]) == SLICE_DOCS
    assert all(x["broadcast"] > 0 and x["received"] > 0 for x in two["exchange_a"])
    assert all(x["bytes_sent"] > 0 and x["control_rounds"] > 0 for x in two["exchange_a"])
    assert all(k["flash_attn"] == 0 for k in runs["p2r0"][1])  # the CPU launches no kernel
    assert all(r > 0 for b in two["b"] for r in b["rounds"])
    # the JAX package in one process over the same files
    jax_replies, port_replies = cs.mp_replies(base, "jax", 1), cs.mp_replies(base, "p2r0", 2)
    assert jax_replies.keys() == port_replies.keys()
    for q, want in jax_replies.items():
        assert cs.ranks_agree(want, port_replies[q], 1e-4), q
        assert max(abs(a[1] - b[1]) for a, b in zip(want, port_replies[q])) < 1e-4
    jg, tg = cs.mp_graph(base, "jax", 1), cs.mp_graph(base, "p2r0", 2)
    assert jg["pairs"].keys() == tg["pairs"].keys()
    assert max(abs(jg["pairs"][k] - tg["pairs"][k]) for k in jg["pairs"]) < 1e-4
    assert jg["labels"] == tg["labels"]
    assert jg["dists"].keys() == tg["dists"].keys() and all(
        abs(jg["dists"][k] - tg["dists"][k]) < 1e-4 or jg["dists"][k] == tg["dists"][k]
        for k in jg["dists"])


FAILING = """
import dataclasses, threading, time

class S(pw.Schema):
    x: int

def boom(key, row, time, is_addition):
    if row["x"] == 0:
        raise RuntimeError("boom")

t = pw.io.jsonlines.read("in", schema=S, mode="streaming")
s = t.groupby(t.x).reduce(t.x, n=pw.reducers.count())
pw.io.subscribe(s, on_change=boom)
connectors = list(pw.G.connectors)

def stopper():  # the run would end by itself only here
    time.sleep(30)
    for c in connectors:
        c._stop.set()
        c.close()

threading.Thread(target=stopper, daemon=True).start()
# callbacks on the engine thread: the failure ends this process's run at once
pw.run(config=dataclasses.replace(RUN["config"], columnar_subscribe=False))
"""


def test_a_failing_process_ends_its_peer(tmp_path):
    """A process whose run raises closes its end of the mesh: its peer's
    next wait fails at once, and both exit non-zero, well inside their
    timeouts."""
    import time

    data = tmp_path / "in"
    data.mkdir()
    for f in range(6):
        (data / f"f{f}.jsonl").write_text("".join(
            json.dumps({"x": 0 if f == 0 and i == 3 else i + 1}) + "\n" for i in range(8)))
    t0 = time.monotonic()
    outs = _wait(_start(HEADER + textwrap.dedent(FAILING), tmp_path, 2, 1))
    assert time.monotonic() - t0 < 25
    assert all(rc != 0 for rc, _out, _err in outs), outs
    assert any("RuntimeError: boom" in err for _rc, _out, err in outs)
    assert any("ConnectionError" in err or "peer mesh closed" in err
               for _rc, _out, err in outs), [e[-2000:] for _r, _o, e in outs]
