"""Kill and restart of persistent port programs (``pathway_tpu_torch``):
the counterparts of ``tests/test_crash_recovery.py``'s three cases and of
``tests/test_multiprocess.py::test_two_process_recovery_resume``.

Each program is a fresh interpreter running ``pathway_tpu_torch``; it gets
its input directory, output file, stop marker and store on its command
line and builds its ``pw.persistence.Config`` from them (the port reads no
``PATHWAY_*`` variable). A program streams until the stop marker exists,
then finishes its pass and exits; a SIGKILL ends it without warning. The
final counts after the last (graceful) run must equal the batch truth,
which the JAX package computes from the same files in this process. The
scale case streams 2,000,000 rows (JAX's streams 5,000,000 on its gate box;
the port's run holds the same 4,096-word vocabulary). Every wait is
bounded and every test has a timeout."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import pathway_tpu as JPW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROG = r"""
import os, sys, threading, time
import pathway_tpu_torch as pw

src, out, stop, store = sys.argv[1:5]

class S(pw.Schema):
    word: str

t = pw.io.jsonlines.read(src, schema=S, mode="streaming", refresh_interval=0.1,
                         persistent_id="words")
counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, out)
conns = list(pw.G.connectors)

# stop the (otherwise endless) streaming run once a marker file appears: the
# reader finishes the pass it is in, then closes its source
def stopper():
    while not os.path.exists(stop):
        time.sleep(0.1)
    for c in conns:
        c._stop.set()

threading.Thread(target=stopper, daemon=True).start()
pw.run(persistence_config=pw.persistence.Config(
    backend=pw.persistence.Backend.filesystem(store)))
"""


def _env() -> dict:
    # one torch thread a child: the tier-1 run shares the host's cores
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _start(tmp_path, out: str):
    prog = tmp_path / "prog.py"
    if not prog.exists():
        prog.write_text(PROG)
    return subprocess.Popen(
        [sys.executable, str(prog), str(tmp_path / "src"), str(tmp_path / out),
         str(tmp_path / "stop"), str(tmp_path / "store")], env=_env())


def _final_counts(path) -> dict:
    net: dict = {}
    if not os.path.exists(path):
        return net
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:  # a line cut by the SIGKILL
                continue
            net[rec["word"]] = net.get(rec["word"], 0) + (
                rec["c"] * (1 if rec["diff"] > 0 else -1))
    return {k: v for k, v in net.items() if v}


def _jax_truth(src) -> dict:
    """The batch counts of every file under ``src``, by the JAX package."""
    from pathway_tpu.internals import run as j_run

    JPW.clear_graph()

    class S(JPW.Schema):
        word: str

    t = JPW.io.jsonlines.read(str(src), schema=S, mode="static")
    counts = t.groupby(t.word).reduce(t.word, c=JPW.reducers.count())
    cap = j_run.capture_table(counts)
    JPW.clear_graph()
    return {w: c for w, c in cap.state.rows.values()}


def _graceful(tmp_path, out: str, timeout: float) -> dict:
    (tmp_path / "stop").write_text("")
    p = _start(tmp_path, out)
    try:
        p.wait(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
    assert p.returncode == 0
    return _final_counts(tmp_path / out)


def _kill_after(tmp_path, out: str, delay: float) -> None:
    p = _start(tmp_path, out)
    try:
        time.sleep(delay)
        os.kill(p.pid, signal.SIGKILL)
    finally:
        p.wait(timeout=30)


@pytest.mark.timeout(120)
def test_sigkill_midrun_then_restart_exactly_once(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text("".join(json.dumps({"word": w}) + "\n"
                                         for w in ["cat", "dog", "cat"]))
    p = _start(tmp_path, "out1.jsonl")
    try:
        deadline = time.time() + 60
        while time.time() < deadline and _final_counts(tmp_path / "out1.jsonl").get("cat") != 2:
            time.sleep(0.1)
        assert _final_counts(tmp_path / "out1.jsonl").get("cat") == 2, "no counts"
        (src / "b.jsonl").write_text("".join(json.dumps({"word": w}) + "\n"
                                             for w in ["cat", "bird"]))
        while time.time() < deadline and _final_counts(tmp_path / "out1.jsonl").get("cat") != 3:
            time.sleep(0.1)
        os.kill(p.pid, signal.SIGKILL)
    finally:
        p.wait(timeout=30)
    (src / "c.jsonl").write_text(json.dumps({"word": "dog"}) + "\n")
    counts = _graceful(tmp_path, "out2.jsonl", 60)
    assert counts == {"cat": 3, "dog": 2, "bird": 1} == _jax_truth(src)


@pytest.mark.timeout(300)
def test_kill_restart_cycles_exactly_once(tmp_path):
    """Repeated SIGKILL at varied points mid-stream, new data arriving
    between crashes, then one graceful run."""
    import random

    rng = random.Random(7)
    src = tmp_path / "src"
    src.mkdir()
    vocab = ["alpha", "beta", "gamma", "delta", "epsilon"]

    def add_file(name: str, n: int) -> None:
        (src / name).write_text("".join(json.dumps({"word": rng.choice(vocab)}) + "\n"
                                        for _ in range(n)))

    add_file("f0.jsonl", 2000)
    add_file("f1.jsonl", 2000)
    for cycle, delay in enumerate([1.0, 2.5, 4.0, 1.5]):
        _kill_after(tmp_path, f"out{cycle}.jsonl", delay)
        add_file(f"g{cycle}.jsonl", 500)
    counts = _graceful(tmp_path, "out4.jsonl", 120)
    assert counts == _jax_truth(src)
    assert sum(counts.values()) == 6000


@pytest.mark.timeout(360)
def test_recovery_torture_at_scale(tmp_path):
    """Millions of rows streamed with persistence, three SIGKILLs at
    staggered points mid-ingest, then one graceful run: the final counts
    equal the batch truth exactly."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(11)
    vocab = np.array([f"w{i}" for i in range(4096)])
    n_rows, n_files = 2_000_000, 10
    per = n_rows // n_files
    expected: dict[str, int] = {}
    for fi in range(n_files):
        words = vocab[rng.integers(0, len(vocab), per)]
        uniq, cnt = np.unique(words, return_counts=True)
        for w, c in zip(uniq.tolist(), cnt.tolist()):
            expected[w] = expected.get(w, 0) + c
        (src / f"f{fi}.jsonl").write_text("".join('{"word": "%s"}\n' % w for w in words.tolist()))
    for cycle, delay in enumerate((3.0, 5.0, 4.0)):
        _kill_after(tmp_path, f"out{cycle}.jsonl", delay)
    counts = _graceful(tmp_path, "out3.jsonl", 240)
    assert sum(counts.values()) == n_rows
    assert counts == expected


@pytest.mark.timeout(240)
def test_two_process_recovery_resume(tmp_path, monkeypatch):
    """Persistence across two port processes: each keeps its own snapshot
    log and metadata under its process id; the second two-process run,
    with extra input, resumes and gives the combined counts (the JAX
    package's one-process run of the same program is the reference)."""
    from tests.test_torch_multiprocess import _jax_run, _shards, _spawn

    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text("".join(json.dumps({"word": w}) + "\n"
                                         for w in ["cat", "dog", "cat"]))
    script = """
    class S(pw.Schema):
        word: str

    t = pw.io.jsonlines.read("src", schema=S, mode="static", persistent_id="words-src")
    counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
    pw.io.jsonlines.write(counts, "OUT")
    pw.run(persistence_config=pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem("store")), **RUN)
    """

    def net(rows):
        out: dict = {}
        for r in rows:
            out[(r["word"], r["c"])] = out.get((r["word"], r["c"]), 0) + r["diff"]
        return {w: c for (w, c), d in out.items() if d > 0}

    _spawn(script.replace("OUT", "out1.jsonl"), tmp_path, processes=2)
    assert net(_shards(tmp_path, "out1.jsonl")) == {"cat": 2, "dog": 1}
    for p in range(2):
        assert (tmp_path / "store" / "metadata" / f"worker-{p}").exists()
    (src / "b.jsonl").write_text("".join(json.dumps({"word": w}) + "\n"
                                         for w in ["cat", "bird"]))
    _spawn(script.replace("OUT", "out2.jsonl"), tmp_path, processes=2)
    got = net(_shards(tmp_path, "out2.jsonl"))
    assert got == {"cat": 3, "dog": 1, "bird": 1}
    # the JAX package, one process, its own store, the same two runs
    jdir = tmp_path / "jax"
    jdir.mkdir()
    (jdir / "src").mkdir()
    from pathway_tpu.internals import config as j_config

    try:
        (jdir / "src" / "a.jsonl").write_text((src / "a.jsonl").read_text())
        _jax_run(script.replace("OUT", "out1.jsonl"), jdir, monkeypatch)
        (jdir / "src" / "b.jsonl").write_text((src / "b.jsonl").read_text())
        _jax_run(script.replace("OUT", "out2.jsonl"), jdir, monkeypatch)
    finally:
        j_config.set_persistence_config(None)
    with open(jdir / "out2.jsonl") as f:
        assert net([json.loads(line) for line in f]) == got


@pytest.mark.timeout(300)
def test_phase22_slice_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 22's four arms at a small size on the CPU:
    256 docs of phase 4's corpus recipe in 8 files, 8 queries, the small
    test encoder in f32 (its child, for the SIGKILL arm, a fresh port
    process loading the pickled weights). Every bar of the chip phase but
    the kernel launch counts, which the CPU does not make."""
    import pickle

    import chip_smoke as cs
    import pathway_tpu_torch as TPW
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.models.transformer import TransformerConfig
    from pathway_tpu_torch.xpacks import llm
    from tests.torch_parity import SMALL, np_encoder_params

    import torch

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    docs, queries = cs.corpus(n_queries=8)
    npp = np_encoder_params(seed=4)
    params = tmp_path / "params.pkl"
    with open(params, "wb") as fh:
        pickle.dump(npp, fh)
    model = SentenceEmbedderModel(TransformerConfig(**SMALL, dtype=torch.float32),
                                  params=from_jax_params(npp),
                                  tokenizer=HashTokenizer(vocab_size=SMALL["vocab_size"],
                                                          max_length=64),
                                  max_length=64, device="cpu")
    monkeypatch.setattr(cs, "RAG_BATCH", 64)
    spec = cs.p22_setup(str(tmp_path / "p22"), docs[:256], queries)
    spec.update(dim=SMALL["hidden"], device="cpu", batch=64, knn={"device": "cpu"},
                model={"params": str(params), "cfg": dict(SMALL), "dtype": "float32",
                       "max_len": 64})
    try:
        launches = cs.p22_arms(TPW, llm, model, spec, "cpu")
    finally:
        TPW.clear_graph()
        model.close()
    assert launches == {"a": 0, "b": 0, "c": 0, "d": 0}  # the CPU launches no kernel
