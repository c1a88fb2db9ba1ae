"""Persistence in the port (``pathway_tpu_torch/persistence/``) held
against the JAX package's on the same inputs.

The counterparts of ``tests/test_persistence.py`` (16 cases) and
``tests/test_persistence_matrix.py`` (7) run each case through both
packages with the same bars; the kill/restart cases of
``tests/test_crash_recovery.py`` and the two-process resume are in
``tests/test_torch_crash_recovery.py``. Beside them: the small test
encoder behind a deferred embed UDF, resumed in each package and held
against its own uninterrupted run (exactly) and against the other package
(``atol=1e-4``); ``udf_caching`` with a ``DiskCache`` hit byte-equal to its
miss; operator state holding a tensor through a snapshot; a file changed
and one deleted while a streaming program was down, each retracted once;
the Kafka, Python and HTTP readers resumed past their stored offsets; the
``persist.put`` chaos site; the CLI's ``replay``; and the stores' isolation
(the port refuses a JAX store and any JAX class in a store). Every wait is
bounded."""

from __future__ import annotations

import io as io_mod
import json
import pickle
import threading
import time
from importlib import import_module

import numpy as np
import pytest
import torch

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu.internals import config as j_config
from pathway_tpu_torch.engine.state import ForeignStoreError, host_state, place_state

PACKAGES = ("jax", "torch")
PW = {"jax": JPW, "torch": TPW}

pytestmark = pytest.mark.timeout(120)


@pytest.fixture(autouse=True)
def _clean():
    yield
    j_config.set_persistence_config(None)
    JPW.clear_graph()
    TPW.clear_graph()


def _mod(pkg: str, name: str):
    return import_module(f"{PW[pkg].__name__}.persistence.{name}")


def _loads(pkg: str, blob: bytes):
    return pickle.loads(blob) if pkg == "jax" else place_state(blob)


def _run(pkg: str, cfg, config=None) -> None:
    """One run of the graph built so far, persistent under ``cfg``."""
    pw = PW[pkg]
    if pkg == "jax":
        try:
            pw.run(persistence_config=cfg)
        finally:
            j_config.set_persistence_config(None)
    else:
        pw.run(persistence_config=cfg, config=config)


def _fs_cfg(pkg: str, store, **kw):
    p = PW[pkg].persistence
    return p.Config.simple_config(p.Backend.filesystem(str(store)), **kw)


# ---------------------------------------------------------------- unit layers


@pytest.mark.parametrize("pkg", PACKAGES)
def test_filesystem_backend_roundtrip(pkg, tmp_path):
    b = _mod(pkg, "backends").FilesystemBackend(tmp_path / "store")
    b.put_value("metadata/worker-0", b"abc")
    b.put_value("streams/src/0/0000000000", b"chunk")
    assert b.get_value("metadata/worker-0") == b"abc"
    assert b.list_keys() == ["metadata/worker-0", "streams/src/0/0000000000"]
    assert b.list_prefix("streams/") == ["streams/src/0/0000000000"]
    b.remove_key("metadata/worker-0")
    assert b.list_keys() == ["streams/src/0/0000000000"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_log_replay_consolidates(pkg):
    s = _mod(pkg, "snapshot")
    b = _mod(pkg, "backends").MemoryBackend()
    w = s.SnapshotLogWriter(b, "src", 0)
    w.write_rows([(1, ("a",), 1), (2, ("b",), 1)])
    w.advance(100, offset={"f": 1})
    w.write_rows([(1, ("a",), -1), (3, ("c",), 1)])
    w.advance(200, offset={"f": 2})
    rows, offset, _ = s.SnapshotLogReader(b, "src", 0).replay()
    assert sorted(rows) == [(2, ("b",), 1), (3, ("c",), 1)]
    assert offset == {"f": 2}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_log_threshold_cuts_unfinalized_chunks(pkg):
    s = _mod(pkg, "snapshot")
    b = _mod(pkg, "backends").MemoryBackend()
    w = s.SnapshotLogWriter(b, "src", 0)
    w.write_rows([(1, ("a",), 1)])
    w.advance(100)
    w.write_rows([(2, ("b",), 1)])
    w.advance(200)
    rows, _, stale = s.SnapshotLogReader(b, "src", 0).replay(threshold_time=150)
    assert rows == [(1, ("a",), 1)]
    assert stale == [s._chunk_key("src", 0, 1)]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_writer_resumes_sequence(pkg):
    s = _mod(pkg, "snapshot")
    b = _mod(pkg, "backends").MemoryBackend()
    w1 = s.SnapshotLogWriter(b, "src", 0)
    w1.write_rows([(1, ("a",), 1)])
    w1.advance(100)
    w2 = s.SnapshotLogWriter(b, "src", 0)  # new run, same backend
    w2.write_rows([(2, ("b",), 1)])
    w2.advance(200)
    rows, _, _ = s.SnapshotLogReader(b, "src", 0).replay()
    assert sorted(rows) == [(1, ("a",), 1), (2, ("b",), 1)]
    assert b.list_prefix("streams/src/0/")[-1] == s._chunk_key("src", 0, 1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_replay_tolerates_torn_trailing_chunk(pkg):
    """A crash mid-put can leave truncated bytes as the log's tail:
    replay keeps everything before the torn chunk, marks it stale and
    never raises."""
    s = _mod(pkg, "snapshot")
    b = _mod(pkg, "backends").MemoryBackend()
    w = s.SnapshotLogWriter(b, "src", 0)
    w.write_rows([(1, ("a",), 1)])
    w.advance(100, offset={"f": 1})
    w.write_rows([(2, ("b",), 1)])
    w.advance(200, offset={"f": 2})
    torn = s._chunk_key("src", 0, 2)
    b.put_value(torn, b"\x80\x04truncated-mid-write")
    rows, offset, stale = s.SnapshotLogReader(b, "src", 0).replay()
    assert sorted(rows) == [(1, ("a",), 1), (2, ("b",), 1)]
    assert offset == {"f": 2}
    assert torn in stale


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_replay_torn_chunk_cuts_the_rest(pkg):
    s = _mod(pkg, "snapshot")
    b = _mod(pkg, "backends").MemoryBackend()
    w = s.SnapshotLogWriter(b, "src", 0)
    w.write_rows([(1, ("a",), 1)])
    w.advance(100, offset={"f": 1})
    w.write_rows([(2, ("b",), 1)])
    w.advance(200, offset={"f": 2})
    b.put_value(s._chunk_key("src", 0, 1), b"not a pickle at all")
    rows, offset, stale = s.SnapshotLogReader(b, "src", 0).replay()
    assert rows == [(1, ("a",), 1)]
    assert offset == {"f": 1}
    assert stale == [s._chunk_key("src", 0, 1)]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metadata_threshold_consensus(pkg):
    st = _mod(pkg, "state")
    b = _mod(pkg, "backends").MemoryBackend()
    m0 = st.MetadataAccessor(b, worker_id=0, total_workers=2)
    m1 = st.MetadataAccessor(b, worker_id=1, total_workers=2)
    assert m0.threshold_time() is None  # nobody finalized
    m0.update(finalized_time=300)
    assert m0.threshold_time() is None  # worker 1 missing
    m1.update(finalized_time=250)
    m0b = st.MetadataAccessor(b, worker_id=0, total_workers=2)
    assert m0b.threshold_time() == 250  # min across workers


@pytest.mark.parametrize("pkg", PACKAGES)
def test_mock_backend_records_events(pkg):
    b = _mod(pkg, "backends").MockBackend()
    b.put_value("k", b"v")
    b.get_value("k")
    b.remove_key("k")
    assert b.events == [("put", "k"), ("get", "k"), ("remove", "k")]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cached_object_storage(pkg, tmp_path):
    """URI-keyed object blobs (no port connector uses them yet): the same
    calls give the same answers in both packages, across a reopen."""
    co = _mod(pkg, "cached_objects")
    b = _mod(pkg, "backends").FilesystemBackend(tmp_path / "store")
    c = co.CachedObjectStorage(b)
    c.put("s3://bkt/a.csv", 3, b"one")
    c.put("s3://bkt/b.csv", "etag-1", b"two")
    c.put("s3://bkt/a.csv", 4, b"one, again")
    c2 = co.CachedObjectStorage(_mod(pkg, "backends").FilesystemBackend(tmp_path / "store"))
    assert c2.get("s3://bkt/a.csv") == (4, b"one, again")
    assert c2.get_version("s3://bkt/a.csv", 3) is None
    assert c2.get_version("s3://bkt/b.csv", "etag-1") == b"two"
    assert c2.contains("s3://bkt/b.csv", "etag-1") and not c2.contains("s3://bkt/c.csv", 1)
    assert c2.stored_uris() == {"s3://bkt/a.csv": 4, "s3://bkt/b.csv": "etag-1"}
    c2.remove("s3://bkt/b.csv")
    assert c2.get("s3://bkt/b.csv") is None
    assert len(b.list_prefix("objects/")) == 1


# ------------------------------------------------------------- end-to-end fs


def _write_csv(path, rows: list[str]):
    path.write_text("word\n" + "\n".join(rows) + "\n")


def _wordcount(pkg: str, src, out, store, mode: str = "persisting", pid: str = "words-src"):
    """One 'process lifetime' of the wordcount app."""
    pw = PW[pkg]
    pw.clear_graph()

    class InSchema(pw.Schema):
        word: str

    words = pw.io.fs.read(str(src), format="csv", schema=InSchema, mode="static",
                          persistent_id=pid)
    counts = words.groupby(words.word).reduce(words.word, count=pw.reducers.count())
    pw.io.jsonlines.write(counts, str(out))
    _run(pkg, _fs_cfg(pkg, store, persistence_mode=mode))


def _entries(out) -> list[dict]:
    with open(out) as f:
        return [json.loads(line) for line in f]


def _final_counts(out) -> dict[str, int]:
    state: dict[str, int] = {}
    for e in sorted(_entries(out), key=lambda e: e["time"]):
        if e["diff"] > 0:
            state[e["word"]] = e["count"]
        elif state.get(e["word"]) == e["count"]:
            del state[e["word"]]
    return state


def _logged_rows(pkg: str, store, pid: str, worker: int = 0) -> list:
    b = _mod(pkg, "backends").FilesystemBackend(store)
    rows = []
    for key in b.list_prefix(f"streams/{pid}/{worker}/"):
        rows.extend(_loads(pkg, b.get_value(key))["rows"])
    return rows


@pytest.mark.parametrize("pkg", PACKAGES)
def test_wordcount_resume_exactly_once(pkg, tmp_path):
    """Run, add more input, re-run against the same store: the resumed run
    must not re-read file 1 (its rows come from the snapshot) and final
    counts must combine both files."""
    src = tmp_path / "src"
    src.mkdir()
    store = tmp_path / "store"
    _write_csv(src / "a.csv", ["cat", "dog", "cat"])
    _wordcount(pkg, src, tmp_path / "out1.jsonl", store)
    assert _final_counts(tmp_path / "out1.jsonl") == {"cat": 2, "dog": 1}
    _write_csv(src / "b.csv", ["cat", "bird"])
    _wordcount(pkg, src, tmp_path / "out2.jsonl", store)
    assert _final_counts(tmp_path / "out2.jsonl") == {"cat": 3, "dog": 1, "bird": 1}
    words = sorted(r[1][0] for r in _logged_rows(pkg, store, "words-src") if r[2] > 0)
    assert words == ["bird", "cat", "cat", "cat", "dog"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unchanged_input_not_reprocessed(pkg, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    store = tmp_path / "store"
    _write_csv(src / "a.csv", ["x", "y"])
    _wordcount(pkg, src, tmp_path / "out1.jsonl", store)
    before = len(_logged_rows(pkg, store, "words-src"))
    _wordcount(pkg, src, tmp_path / "out2.jsonl", store)
    assert len(_logged_rows(pkg, store, "words-src")) == before == 2
    assert _final_counts(tmp_path / "out2.jsonl") == {"x": 1, "y": 1}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metadata_offsets_persisted(pkg, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    store = tmp_path / "store"
    _write_csv(src / "a.csv", ["q"])
    _wordcount(pkg, src, tmp_path / "out.jsonl", store)
    p = _mod(pkg, "state")
    meta = p.MetadataAccessor(_mod(pkg, "backends").FilesystemBackend(store), 0)
    assert meta.current.finalized_time is not None
    offs = meta.current.offsets.get("words-src")
    assert offs and any(path.endswith("a.csv") for path in offs)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_operator_persisting_mode(pkg, tmp_path):
    """Operator-persisting: groupby state is snapshotted and restored, inputs
    are sought but not replayed — the resumed run emits only updates caused
    by new data, on top of restored aggregates."""
    src = tmp_path / "src"
    src.mkdir()
    store = tmp_path / "store"
    _write_csv(src / "a.csv", ["cat", "cat", "dog"])
    _wordcount(pkg, src, tmp_path / "o1.jsonl", store, "operator_persisting", "w")
    assert {(e["word"], e["count"]) for e in _entries(tmp_path / "o1.jsonl")
            if e["diff"] > 0} == {("cat", 2), ("dog", 1)}
    _write_csv(src / "b.csv", ["cat"])
    _wordcount(pkg, src, tmp_path / "o2.jsonl", store, "operator_persisting", "w")
    assert [(e["word"], e["count"], e["diff"]) for e in _entries(tmp_path / "o2.jsonl")] == [
        ("cat", 2, -1), ("cat", 3, 1)]
    if pkg == "torch":
        from pathway_tpu_torch.internals import run as t_run

        assert t_run.LAST_PERSISTENCE_STATS["restored_operators"] >= 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_speedrun_replay_mode(pkg, tmp_path):
    """speedrun_replay: replay the snapshot only; don't read new data."""
    src = tmp_path / "src"
    src.mkdir()
    store = tmp_path / "store"
    _write_csv(src / "a.csv", ["cat", "dog"])
    _wordcount(pkg, src, tmp_path / "o1.jsonl", store)
    _write_csv(src / "b.csv", ["bird"])  # present but must be ignored
    _wordcount(pkg, src, tmp_path / "o2.jsonl", store, "speedrun_replay")
    assert _final_counts(tmp_path / "o2.jsonl") == {"cat": 1, "dog": 1}


def _subject_wordcount(pkg: str, items, out, store):
    pw = PW[pkg]
    pw.clear_graph()

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for x in items:
                self.next(word=x)

    class InSchema(pw.Schema):
        word: str

    t = pw.io.python.read(Subject(), schema=InSchema, persistent_id="pysrc")
    counts = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    pw.io.jsonlines.write(counts, str(out))
    _run(pkg, _fs_cfg(pkg, store))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_python_connector_persistence(pkg, tmp_path):
    """ConnectorSubject resume: second run's deterministic replay is skipped
    via the stored offset; snapshot restores the data."""
    store = tmp_path / "store"
    _subject_wordcount(pkg, ["a", "b"], tmp_path / "o1.jsonl", store)
    assert _final_counts(tmp_path / "o1.jsonl") == {"a": 1, "b": 1}
    _subject_wordcount(pkg, ["a", "b", "a", "c"], tmp_path / "o2.jsonl", store)
    assert _final_counts(tmp_path / "o2.jsonl") == {"a": 2, "b": 1, "c": 1}


def _replay_cfg(pkg: str, store, access: str, mode: str | None = None,
                cont: bool | None = None):
    """JAX: the ``PATHWAY_REPLAY_STORAGE`` family's Config
    (``get_persistence_config``); the port: the CLI's ``replay_config``
    or the same Config built by hand."""
    if pkg == "jax":
        import dataclasses

        prev = j_config.pathway_config
        j_config.pathway_config = dataclasses.replace(
            prev, replay_storage=str(store), snapshot_access=access,
            persistence_mode=mode, continue_after_replay=bool(cont))
        try:
            return j_config.get_persistence_config()
        finally:
            j_config.pathway_config = prev
    p = TPW.persistence
    return p.Config(backend=p.Backend.filesystem(str(store)),
                    persistence_mode=mode or "persisting", snapshot_access=access,
                    continue_after_replay=bool(cont) or access != "replay")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_env_record_then_replay_roundtrip(pkg, tmp_path):
    """snapshot_access=record writes snapshots for sources without explicit
    persistent ids; =replay recomputes identical results with the original
    inputs gone (JAX through its environment, the port through the Config
    those variables describe)."""
    pw = PW[pkg]
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    (in_dir / "d.jsonl").write_text("".join(json.dumps({"word": w}) + "\n"
                                            for w in ["a", "b", "a"]))

    class S(pw.Schema):
        word: str

    def build_and_run(out, cfg):
        pw.clear_graph()
        t = pw.io.jsonlines.read(str(in_dir), schema=S, mode="static")
        counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
        pw.io.jsonlines.write(counts, str(out))
        _run(pkg, cfg)
        return {e["word"]: e["c"] for e in _entries(out) if e["diff"] > 0}

    recorded = build_and_run(tmp_path / "o1.jsonl", _replay_cfg(pkg, tmp_path / "rec", "record"))
    assert recorded == {"a": 2, "b": 1}
    (in_dir / "d.jsonl").unlink()
    replayed = build_and_run(tmp_path / "o2.jsonl",
                             _replay_cfg(pkg, tmp_path / "rec", "replay", "batch"))
    assert replayed == recorded


@pytest.mark.parametrize("pkg", PACKAGES)
def test_env_replay_defaults_to_stop_at_end_of_log(pkg, tmp_path):
    """A replay-access Config without a mode or the continue flag stops at
    the end of the log (JAX's environment; the port's CLI ``replay``)."""
    if pkg == "jax":
        cfg = _replay_cfg(pkg, tmp_path, "replay")
    else:
        from pathway_tpu_torch.cli import replay_config

        cfg = replay_config(str(tmp_path))
    assert cfg.continue_after_replay is False
    manager = _mod(pkg, "engine_store").PersistenceManager(cfg)
    assert manager.continue_after_replay is False and manager.do_replay
    assert not manager.do_record


# ------------------------------------------------ the persistence matrix


class _StubS3:
    """boto3-shaped client over a dict — drives the REAL S3Backend code."""

    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    def put_object(self, Bucket, Key, Body):
        self.blobs[Key] = bytes(Body)

    def get_object(self, Bucket, Key):
        if Key not in self.blobs:
            raise KeyError(Key)
        return {"Body": io_mod.BytesIO(self.blobs[Key])}

    def list_objects_v2(self, Bucket, Prefix, **kw):
        return {"Contents": [{"Key": k} for k in sorted(self.blobs) if k.startswith(Prefix)],
                "IsTruncated": False}

    def delete_object(self, Bucket, Key):
        self.blobs.pop(Key, None)


class _StubAzureContainer:
    """Duck-typed azure ContainerClient over an in-memory dict."""

    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    def upload_blob(self, name, data, overwrite=False):
        if not overwrite and name in self.blobs:
            raise FileExistsError(name)
        self.blobs[name] = bytes(data)

    def download_blob(self, name):
        data = self.blobs[name]

        class _Dl:
            def readall(self):
                return data

        return _Dl()

    def list_blob_names(self, name_starts_with=None):
        return sorted(k for k in self.blobs
                      if name_starts_with is None or k.startswith(name_starts_with))

    def delete_blob(self, name):
        self.blobs.pop(name, None)


def _counting_pipeline(pkg: str, src_dir, cfg, expect_rows: int, out_rows: list,
                       config=None):
    """A streaming jsonlines read (persistent id ``words``) counted by
    word, stopped once ``expect_rows`` inserts reached it (bounded)."""
    pw = PW[pkg]
    pw.clear_graph()

    class WordSchema(pw.Schema):
        word: str

    t = pw.io.jsonlines.read(str(src_dir), schema=WordSchema, mode="streaming",
                             refresh_interval=0.05, persistent_id="words")
    seen: list = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(
        (row["word"], 1 if is_addition else -1)))
    counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
    pw.io.subscribe(counts, on_change=lambda key, row, time, is_addition: out_rows.append(
        (row["word"], row["c"], 1 if is_addition else -1)))
    conns = list(pw.G.connectors)

    def stop():
        deadline = time.time() + 30
        while time.time() < deadline and len([s for s in seen if s[1] > 0]) < expect_rows:
            time.sleep(0.02)
        for c in conns:
            c._stop.set()
            c.close()

    threading.Thread(target=stop, daemon=True).start()
    _run(pkg, cfg, config)
    return seen


def _net(pairs) -> dict:
    net: dict = {}
    for w, d in pairs:
        net[w] = net.get(w, 0) + d
    return {k: v for k, v in net.items() if v}


def _final(out) -> dict:
    final: dict = {}
    for w, c, d in out:
        final[w] = final.get(w, 0) + c * d
    return {k: v for k, v in final.items() if v}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_s3_backed_persistence_restart_exactly_once(pkg, tmp_path):
    pwp = PW[pkg].persistence
    client = _StubS3()
    cfg = pwp.Config(backend=pwp.S3Backend(bucket="bkt", prefix="persist", client=client))
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text('{"word": "cat"}\n{"word": "dog"}\n')
    out1: list = []
    seen1 = _counting_pipeline(pkg, src, cfg, 2, out1)
    assert sorted(w for w, d in seen1 if d > 0) == ["cat", "dog"]
    assert any(k.startswith("persist/streams/words/") for k in client.blobs)
    (src / "b.jsonl").write_text('{"word": "cat"}\n')
    out2: list = []
    seen2 = _counting_pipeline(pkg, src, cfg, 3, out2)
    assert _net(seen2) == {"cat": 2, "dog": 1}
    assert _final(out2) == {"cat": 2, "dog": 1}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_s3_backend_list_and_remove_roundtrip(pkg):
    b = PW[pkg].persistence.S3Backend(bucket="bkt", prefix="p", client=_StubS3())
    b.put_value("x/one", b"1")
    b.put_value("x/two", b"2")
    assert b.list_prefix("x/") == ["x/one", "x/two"]
    assert b.get_value("x/two") == b"2"
    b.remove_key("x/one")
    assert b.list_prefix("x/") == ["x/two"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multiworker_persistence_restart(pkg, tmp_path, monkeypatch):
    """Two scheduler threads x persistence (JAX's PATHWAY_THREADS=2, the
    port's EngineConfig(threads=2))."""
    config = None
    if pkg == "jax":
        monkeypatch.setenv("PATHWAY_THREADS", "2")
    else:
        config = TPW.EngineConfig(threads=2)
    pwp = PW[pkg].persistence
    cfg = pwp.Config(backend=pwp.Backend.filesystem(str(tmp_path / "store")))
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text("".join('{"word": "w%d"}\n' % (i % 5) for i in range(50)))
    out1: list = []
    seen1 = _counting_pipeline(pkg, src, cfg, 50, out1, config)
    assert len([s for s in seen1 if s[1] > 0]) == 50
    (src / "b.jsonl").write_text('{"word": "w0"}\n')
    out2: list = []
    seen2 = _counting_pipeline(pkg, src, cfg, 51, out2, config)
    assert sum(_net(seen2).values()) == 51
    assert _final(out2) == {"w0": 11, "w1": 10, "w2": 10, "w3": 10, "w4": 10}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_operator_persisting_mode_restores_state(pkg, tmp_path):
    pwp = PW[pkg].persistence
    cfg = pwp.Config(backend=pwp.Backend.filesystem(str(tmp_path / "store")),
                     persistence_mode="operator_persisting")
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text('{"word": "x"}\n{"word": "x"}\n')
    out1: list = []
    _counting_pipeline(pkg, src, cfg, 2, out1)
    assert _final(out1) == {"x": 2}
    (src / "b.jsonl").write_text('{"word": "x"}\n')
    out2: list = []
    _counting_pipeline(pkg, src, cfg, 1, out2)
    inserts = [(w, c) for w, c, d in out2 if d > 0]
    assert inserts[-1] == ("x", 3)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_record_then_replay_modes(pkg, tmp_path):
    pwp = PW[pkg].persistence
    store = tmp_path / "store"
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text('{"word": "r"}\n')
    out1: list = []
    _counting_pipeline(pkg, src, pwp.Config(backend=pwp.Backend.filesystem(str(store)),
                                            snapshot_access="record"), 1, out1)
    out2: list = []
    seen2 = _counting_pipeline(pkg, src, pwp.Config(
        backend=pwp.Backend.filesystem(str(store)), snapshot_access="replay",
        continue_after_replay=False), 0, out2)
    assert [w for w, d in seen2 if d > 0] == ["r"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_azure_backed_persistence_restart_exactly_once(pkg, tmp_path):
    pwp = PW[pkg].persistence
    client = _StubAzureContainer()
    cfg = pwp.Config(backend=pwp.Backend.azure("container", account=client, prefix="persist"))
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text('{"word": "cat"}\n{"word": "dog"}\n')
    out1: list = []
    seen1 = _counting_pipeline(pkg, src, cfg, 2, out1)
    assert sorted(w for w, d in seen1 if d > 0) == ["cat", "dog"]
    assert any(k.startswith("persist/streams/words/") for k in client.blobs)
    (src / "b.jsonl").write_text('{"word": "cat"}\n')
    out2: list = []
    seen2 = _counting_pipeline(pkg, src, cfg, 3, out2)
    assert _net(seen2) == {"cat": 2, "dog": 1}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_azure_backend_roundtrip_and_gating(pkg):
    pwp = PW[pkg].persistence
    b = pwp.AzureBlobBackend(container="c", prefix="p", container_client=_StubAzureContainer())
    b.put_value("x/one", b"1")
    b.put_value("x/two", b"2")
    assert b.list_prefix("x/") == ["x/one", "x/two"]
    assert b.get_value("x/two") == b"2"
    b.remove_key("x/one")
    assert b.list_prefix("x/") == ["x/two"]
    with pytest.raises((ImportError, ValueError)):
        pwp.AzureBlobBackend(container="c")
    with pytest.raises(ImportError):
        pwp.S3Backend(bucket="b")


# ------------------------------------- the deferred embed UDF, resumed


VOCAB, MAX_LEN = 1000, 64
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta", "iota", "kappa"]


def _docs(n: int, seed: int = 3) -> list[str]:
    # six words a doc: every batch pads to the same length bucket
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, 6)) for _ in range(n)]


def _write_doc_files(src, docs: list[str], n_files: int, upto: int | None = None) -> None:
    import csv

    src.mkdir(parents=True, exist_ok=True)
    per = -(-len(docs) // n_files)
    for f in range(n_files if upto is None else upto):
        path = src / f"part{f}.csv"
        if path.exists():
            continue
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["doc", "text"])
            w.writerows((i, docs[i]) for i in range(f * per, min(len(docs), (f + 1) * per)))


@pytest.fixture(scope="module")
def encoders():
    """The small test encoder in both packages, the same seeded weights."""
    from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
    from pathway_tpu.models.tokenizer import HashTokenizer as JTok
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from tests.torch_parity import configs, np_encoder_params, to_jax

    npp = np_encoder_params(seed=4)
    jcfg, tcfg = configs("float32")
    jm = JEmbed(jcfg, params=to_jax(npp), tokenizer=JTok(vocab_size=VOCAB, max_length=MAX_LEN),
                max_length=MAX_LEN)
    tm = SentenceEmbedderModel(tcfg, params=from_jax_params(npp),
                               tokenizer=HashTokenizer(vocab_size=VOCAB, max_length=MAX_LEN),
                               max_length=MAX_LEN, device="cpu")
    yield {"jax": jm, "torch": tm}
    jm.close()
    tm.close()


class _Rows:
    """Counts the rows a model embeds (its submit calls)."""

    def __init__(self, model):
        self.model, self.rows = model, 0
        self._submit = model.embed_submit

    def __enter__(self):
        def submit(texts, *a, **k):
            self.rows += len(texts)
            return self._submit(texts, *a, **k)

        self.model.embed_submit = submit
        return self

    def __exit__(self, *exc):
        del self.model.embed_submit


def _embedder(pkg: str, model):
    mod = import_module(f"{PW[pkg].__name__}.xpacks.llm.embedders")
    kw = {"dedup": False} if pkg == "torch" else {}
    return mod.SentenceTransformerEmbedder(model, max_batch_size=16, deferred=True, **kw)


def _embed_run(pkg: str, model, src, store, mode: str = "persisting", out=None):
    """csv docs (persistent id ``docs``) -> the deferred embed UDF; returns
    the run's subscribe stream ``[(key, doc, vec, is_addition)]``."""
    pw = PW[pkg]
    pw.clear_graph()

    class D(pw.Schema):
        doc: int
        text: str

    docs = pw.io.csv.read(str(src), schema=D, mode="static", persistent_id="docs")
    vecs = docs.select(docs.doc, vec=_embedder(pkg, model)(docs.text))
    events: list = []
    pw.io.subscribe(vecs, on_change=lambda key, row, time, is_addition: events.append(
        (key.value, row["doc"], np.asarray(row["vec"]), is_addition)))
    if out is not None:
        pw.io.jsonlines.write(vecs.select(vecs.doc), str(out))
    _run(pkg, _fs_cfg(pkg, store, persistence_mode=mode))
    return events


def _fold(events) -> dict:
    """{key: (doc, vec)} of the live rows; a key live twice fails."""
    live: dict = {}
    for key, doc, vec, add in events:
        if add:
            assert key not in live, f"key {key} inserted twice"
            live[key] = (doc, vec)
        else:
            assert key in live, f"key {key} retracted while not live"
            del live[key]
    return live


def _same(a: dict, b: dict, atol: float = 0.0) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k][0] == b[k][0]
        if atol:
            np.testing.assert_allclose(a[k][1], b[k][1], atol=atol, rtol=0)
        else:
            assert a[k][1].dtype == b[k][1].dtype and a[k][1].tobytes() == b[k][1].tobytes()


@pytest.mark.timeout(240)
@pytest.mark.parametrize("mode", ["persisting", "udf_caching"])
def test_embed_stream_resume_equals_uninterrupted(mode, tmp_path, encoders):
    """Run 1 reads 2 of 4 files, run 2 (a fresh graph, all 4 files) resumes:
    each package's resumed state equals its own uninterrupted run exactly
    (row keys included), the two packages agree within the encoders'
    atol=1e-4, every doc is live once, run 2 read only the new files, and
    under ``udf_caching`` the port's replayed rows are DiskCache hits (no
    encoder row) byte-equal to run 1's vectors."""
    docs = _docs(96)
    finals, firsts = {}, {}
    for pkg in PACKAGES:
        # one source directory for both packages (row keys hash the paths)
        base, src = tmp_path / pkg, tmp_path / "src"
        base.mkdir()
        for f in (2, 3):
            (src / f"part{f}.csv").unlink(missing_ok=True)
        _write_doc_files(src, docs, 4, upto=2)
        with _Rows(encoders[pkg]) as rows1:
            first = _fold(_embed_run(pkg, encoders[pkg], src, base / "store", mode,
                                     out=base / "ids1.jsonl"))
        assert sorted(d for d, _ in first.values()) == list(range(48))
        _write_doc_files(src, docs, 4)
        with _Rows(encoders[pkg]) as rows2:
            resumed = _fold(_embed_run(pkg, encoders[pkg], src, base / "store", mode,
                                       out=base / "ids2.jsonl"))
        # the same files (keys hash their paths), a fresh store
        whole = _fold(_embed_run(pkg, encoders[pkg], src, base / "store-whole"))
        _same(resumed, whole)
        # exactly once: each sink holds each of its docs once, net
        for ids, n in (("ids1.jsonl", 48), ("ids2.jsonl", 96)):
            net: dict = {}
            for e in _entries(base / ids):
                net[e["doc"]] = net.get(e["doc"], 0) + e["diff"]
            assert net == {d: 1 for d in range(n)}, ids
        logged = _logged_rows(pkg, base / "store", "docs")
        assert sorted(r[1][0] for r in logged) == list(range(96)), "run 2 read files 2-3 only"
        assert rows1.rows == 48
        if pkg == "torch" and mode == "udf_caching":
            assert rows2.rows == 48, "replayed rows are cache hits"
            for k, (doc, vec) in first.items():
                assert resumed[k][1].tobytes() == vec.tobytes()
        else:
            assert rows2.rows == 96, "replayed rows are embedded again"
        finals[pkg], firsts[pkg] = resumed, first
    _same(finals["torch"], finals["jax"], atol=1e-4)
    _same(firsts["torch"], firsts["jax"], atol=1e-4)


def test_disk_cache_hit_is_byte_equal_to_its_miss(tmp_path):
    """A tensor value through ``DiskCache``: the hit has the miss's bytes,
    dtype and device (the value is stored in its host form)."""
    from pathway_tpu_torch.internals.udfs import DiskCache, with_cache_strategy

    calls = []

    def f(x):
        calls.append(x)
        g = torch.Generator().manual_seed(x)
        return {"f32": torch.randn(3, 5, generator=g),
                "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
                "i8": torch.randint(-128, 127, (4,), generator=g, dtype=torch.int8)}

    cache = DiskCache(name="t", root=str(tmp_path))
    cached = with_cache_strategy(f, cache)
    miss = cached(7)
    fresh = DiskCache(name="t", root=str(tmp_path))  # a new process's view
    hit = with_cache_strategy(f, fresh)(7)
    assert calls == [7] and fresh.hits == 1
    for name, t in miss.items():
        assert hit[name].dtype == t.dtype and hit[name].device == t.device
        assert hit[name].view(torch.uint8).numpy().tobytes() == \
            t.view(torch.uint8).numpy().tobytes(), name
    raw = fresh._ensure().execute("SELECT v FROM cache").fetchone()[0]
    assert b"torch._utils" not in raw and b"Storage" not in raw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64"])
def test_operator_state_tensor_roundtrip(dtype):
    """A RowwiseNode's replay cache holding tensors (a non-deterministic
    UDF's values) goes through ``state_snapshot`` / ``state_restore`` with
    each tensor's dtype, device and bytes."""
    from pathway_tpu_torch.engine.operators.core import RowwiseNode

    TPW.clear_graph()
    t = TPW.debug.table_from_markdown("a\n1\n2")

    @TPW.udf(deterministic=False)
    def vec(a: int) -> object:
        return torch.arange(4).to(getattr(torch, dtype)) * a

    out = t.select(v=vec(t.a))
    node = out._node
    assert isinstance(node, RowwiseNode) and node.is_stateful()
    cap = TPW.internals.run.capture_table(out)  # runs the graph once
    assert len(cap.state.rows) == 2
    state = node.state_snapshot()
    assert b"torch._utils" not in state
    before = {k: v[1]["v"] for k, v in node._replay_cache.items()}
    node.reset()
    node.state_restore(state)
    after = {k: v[1]["v"] for k, v in node._replay_cache.items()}
    assert sorted(before) == sorted(after) and len(after) == 2
    for k in before:
        assert after[k].dtype == before[k].dtype and after[k].device == before[k].device
        assert torch.equal(after[k], before[k])


@pytest.mark.cuda
def test_operator_state_tensor_comes_back_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = {"v": torch.arange(6, device="cuda", dtype=torch.bfloat16)}
    y = place_state(host_state(x))
    assert y["v"].device.type == "cuda" and y["v"].dtype == torch.bfloat16
    assert torch.equal(y["v"], x["v"])


# ------------------------- the file reader's per-file map, rebuilt on resume


def _stream_until(pkg: str, build, done, timeout: float = 30.0, cfg=None):
    """Run the streaming graph ``build()`` makes until ``done(events)``
    holds (bounded); returns its subscribe events."""
    pw = PW[pkg]
    pw.clear_graph()
    events: list = []
    build(pw, events)
    conns = list(pw.G.connectors)

    def stop():
        deadline = time.time() + timeout
        while time.time() < deadline and not done(events):
            time.sleep(0.02)
        time.sleep(0.3)  # a late extra retraction would land meanwhile
        for c in conns:
            c._stop.set()
            c.close()

    threading.Thread(target=stop, daemon=True).start()
    _run(pkg, cfg)
    return events


@pytest.mark.parametrize("keyed", [False, True], ids=["keyless", "upsert"])
def test_changed_and_deleted_files_retract_once_after_resume(keyed, tmp_path):
    """The port's streaming reader retracts a deleted file's rows and a
    changed file's old rows (JAX's keeps them). A file deleted and one
    changed while the program was down are retracted exactly once at the
    resumed run's first poll: the per-file map is rebuilt from the
    replayed rows."""
    src = tmp_path / "src"
    src.mkdir()

    def write(name, pairs):
        (src / name).write_text("".join(json.dumps({"id": i, "word": w}) + "\n"
                                        for i, w in pairs))

    def build(pw, events):
        if keyed:
            class S(pw.Schema):
                id: int = pw.column_definition(primary_key=True)
                word: str
        else:
            class S(pw.Schema):
                id: int
                word: str
        t = pw.io.jsonlines.read(str(src), schema=S, mode="streaming",
                                 refresh_interval=0.05, persistent_id="files")
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: events.append(
            (row["id"], row["word"], 1 if is_addition else -1)))

    def live(events):
        net: dict = {}
        for i, w, d in events:
            net[(i, w)] = net.get((i, w), 0) + d
        return {k: v for k, v in net.items() if v}

    cfg = _fs_cfg("torch", tmp_path / "store")
    write("a.jsonl", [(1, "x"), (2, "y")])
    write("b.jsonl", [(3, "z")])
    first = _stream_until("torch", build, lambda ev: len(live(ev)) == 3, cfg=cfg)
    assert live(first) == {(1, "x"): 1, (2, "y"): 1, (3, "z"): 1}
    (src / "a.jsonl").unlink()
    time.sleep(0.05)
    write("b.jsonl", [(3, "w")])
    write("c.jsonl", [(4, "v")])
    want = {(3, "w"): 1, (4, "v"): 1}
    second = _stream_until("torch", build, lambda ev: live(ev) == want, cfg=cfg)
    assert live(second) == want
    retracted = [(i, w) for i, w, d in second if d < 0]
    assert sorted(retracted) == [(1, "x"), (2, "y"), (3, "z")], "each old row retracted once"
    inserted = [(i, w) for i, w, d in second if d > 0]
    assert sorted(inserted) == [(1, "x"), (2, "y"), (3, "w"), (3, "z"), (4, "v")]


# ---------------------------------------------- Kafka and HTTP readers


@pytest.mark.parametrize("pkg", PACKAGES)
def test_kafka_reader_resumes_past_its_offset(pkg, tmp_path):
    """The in-memory broker's log position is the offset: the resumed run
    replays the first two messages from the log and reads only the third."""
    pw = PW[pkg]
    kafka = import_module(f"{pw.__name__}.io.kafka")

    def run_once(words, out):
        pw.clear_graph()
        broker = kafka.InMemoryKafkaBroker()
        for w in words:
            broker.produce("t", json.dumps({"word": w}).encode())
        broker.close()  # a closed broker ends its reader once drained

        class S(pw.Schema):
            word: str

        t = pw.io.kafka.read(broker, "t", schema=S, format="json", persistent_id="k")
        counts = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
        pw.io.jsonlines.write(counts, str(out))
        _run(pkg, _fs_cfg(pkg, tmp_path / "store"))

    run_once(["a", "b"], tmp_path / "o1.jsonl")
    assert _final_counts(tmp_path / "o1.jsonl") == {"a": 1, "b": 1}
    run_once(["a", "b", "a"], tmp_path / "o2.jsonl")
    assert _final_counts(tmp_path / "o2.jsonl") == {"a": 2, "b": 1}
    assert len(_logged_rows(pkg, tmp_path / "store", "k")) == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_http_reader_resumes_past_its_byte_offset(pkg, tmp_path):
    """A re-served, growing body: the resumed run skips the bytes the
    stored offset holds and reads only the new line."""
    pw = PW[pkg]

    def run_once(words, out):
        pw.clear_graph()
        body = "".join(json.dumps({"word": w}) + "\n" for w in words).encode()

        class S(pw.Schema):
            word: str

        t = pw.io.http.read("http://log.invalid/words", schema=S, format="json",
                            mode="static", persistent_id="h",
                            _opener=lambda url, headers: io_mod.BytesIO(body))
        counts = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
        pw.io.jsonlines.write(counts, str(out))
        _run(pkg, _fs_cfg(pkg, tmp_path / "store"))

    run_once(["a", "b"], tmp_path / "o1.jsonl")
    assert _final_counts(tmp_path / "o1.jsonl") == {"a": 1, "b": 1}
    run_once(["a", "b", "c"], tmp_path / "o2.jsonl")
    assert _final_counts(tmp_path / "o2.jsonl") == {"a": 1, "b": 1, "c": 1}
    assert len(_logged_rows(pkg, tmp_path / "store", "h")) == 3


# ------------------------------------------------ store writes and faults


def test_persist_put_chaos_keeps_rows_buffered():
    """``SnapshotLogWriter.flush`` faults BEFORE the backend put: the rows
    stay buffered for the next flush, nothing is torn (JAX's
    ``test_persist_put_chaos``)."""
    from pathway_tpu_torch.engine import chaos
    from pathway_tpu_torch.persistence import MemoryBackend, SnapshotLogWriter

    chaos.configure(rate=1.0, seed=0, sites="persist.put")
    try:
        b = MemoryBackend()
        w = SnapshotLogWriter(b, "src", 0)
    finally:
        chaos.configure()
    w.write_rows([(1, ("a",), 1)])
    with pytest.raises(chaos.InjectedFault) as ei:
        w.advance(100)
    assert ei.value.site == "persist.put"
    assert not b.list_prefix("streams/")
    assert w._rows
    w._chaos_put = None
    w.advance(100)
    assert len(b.list_prefix("streams/src/0/")) == 1


class _OneFault:
    """A chaos site that faults on its first roll only."""

    def __init__(self):
        self.rolls = 0

    def maybe_fail(self):
        from pathway_tpu_torch.engine.chaos import InjectedFault

        self.rolls += 1
        if self.rolls == 1:
            raise InjectedFault("persist.put", 1)


def test_injected_put_fault_is_retried_by_the_run(tmp_path, monkeypatch):
    """An injected fault on a commit's chunk leaves its rows buffered; the
    run goes on and the finalizing flush stores them, so a resume is
    exactly-once."""
    from pathway_tpu_torch.engine import chaos

    site = _OneFault()
    real = chaos.site
    monkeypatch.setattr(chaos, "site", lambda name: site if name == "persist.put" else real(name))
    src = tmp_path / "src"
    src.mkdir()
    _write_csv(src / "a.csv", ["cat", "dog"])
    _wordcount("torch", src, tmp_path / "o1.jsonl", tmp_path / "store")
    assert site.rolls >= 2
    monkeypatch.setattr(chaos, "site", real)
    assert sorted(r[1][0] for r in _logged_rows("torch", tmp_path / "store", "words-src")) == [
        "cat", "dog"]
    _write_csv(src / "b.csv", ["cat"])
    _wordcount("torch", src, tmp_path / "o2.jsonl", tmp_path / "store")
    assert _final_counts(tmp_path / "o2.jsonl") == {"cat": 2, "dog": 1}


def test_failed_store_write_fails_the_run(tmp_path):
    """A store write that fails (no injected fault) is never swallowed."""
    from pathway_tpu_torch.persistence import MemoryBackend

    class Broken(MemoryBackend):
        def put_value(self, key, value):
            if key.startswith("streams/"):
                raise OSError("disk full")
            super().put_value(key, value)

    src = tmp_path / "src"
    src.mkdir()
    _write_csv(src / "a.csv", ["cat"])

    class S(TPW.Schema):
        word: str

    TPW.clear_graph()
    t = TPW.io.csv.read(str(src), schema=S, mode="static", persistent_id="w")
    TPW.io.null.write(t)
    with pytest.raises(OSError, match="disk full"):
        TPW.run(persistence_config=TPW.persistence.Config(backend=Broken()))


# --------------------------------------- operator persisting with an index


@pytest.mark.parametrize("pkg", PACKAGES)
def test_operator_persisting_with_an_index_falls_back_to_input_replay(pkg, tmp_path, caplog):
    """The index operator keeps no snapshot (as in JAX): the resumed run of
    an operator-persisting program with an index replays its inputs, warns,
    and answers as a persisting run does."""
    import logging

    pw = PW[pkg]
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.csv").write_text("doc,x,y\n0,1.0,0.0\n1,0.0,1.0\n")

    def run_once(out, n_docs):
        pw.clear_graph()

        class D(pw.Schema):
            doc: int
            x: float
            y: float

        docs = pw.io.csv.read(str(src), schema=D, mode="static", persistent_id="docs")
        vecs = docs.select(docs.doc, vec=pw.apply_with_type(
            lambda x, y: np.array([x, y]), np.ndarray, docs.x, docs.y))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        index = pw.indexing.DataIndex(vecs, pw.indexing.BruteForceKnn(
            vecs.vec, dimensions=2, metric="cos", **kw))
        q = pw.debug.table_from_markdown("q | qx | qy\n1 | 0.9 | 0.1\n2 | 0.1 | 0.9")
        # asked once the index holds every doc
        total = vecs.reduce(n=pw.reducers.count())
        q = q.filter(total.ix_ref().n == n_docs)
        qv = q.select(q.q, qv=pw.apply_with_type(lambda x, y: np.array([x, y]), np.ndarray,
                                                  q.qx, q.qy))
        res = index.query(qv.qv, number_of_matches=1)
        res = res.select(q=qv.restrict(res).q, doc=res.doc)
        pw.io.jsonlines.write(res, str(out))
        with caplog.at_level(logging.WARNING):
            _run(pkg, _fs_cfg(pkg, tmp_path / "store", persistence_mode="operator_persisting"))

    def answers(out):
        net: dict = {}
        for e in _entries(out):
            k = (e["q"], tuple(e["doc"]))
            net[k] = net.get(k, 0) + e["diff"]
        return sorted(k for k, v in net.items() if v)

    run_once(tmp_path / "o1.jsonl", 2)
    assert answers(tmp_path / "o1.jsonl") == [(1, (0,)), (2, (1,))]
    (src / "b.csv").write_text("doc,x,y\n2,0.1,0.9999\n")
    caplog.clear()
    run_once(tmp_path / "o2.jsonl", 3)
    assert answers(tmp_path / "o2.jsonl") == [(1, (0,)), (2, (2,))]
    assert "falling back to input-snapshot replay" in caplog.text
    if pkg == "torch":
        from pathway_tpu_torch.internals import run as t_run

        assert t_run.LAST_PERSISTENCE_STATS["restored_operators"] == 0


# --------------------------------------------------- the CLI's replay


REPLAY_PROG = """
import sys
import pathway_tpu_torch as pw

class S(pw.Schema):
    word: str

t = pw.io.jsonlines.read(sys.argv[1], schema=S, mode="static")
counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, sys.argv[2])
pw.run()
"""


def test_cli_replay_runs_a_program_against_its_record(tmp_path):
    """A program recorded with ``snapshot_access="record"`` is replayed by
    ``replay --record-path`` with its input gone: the same counts. The
    Config reaches the program's ``pw.run`` as an argument, not through
    the environment."""
    from pathway_tpu_torch import cli
    from pathway_tpu_torch.internals import run as t_run

    prog = tmp_path / "prog.py"
    prog.write_text(REPLAY_PROG)
    src = tmp_path / "in"
    src.mkdir()
    (src / "d.jsonl").write_text("".join(json.dumps({"word": w}) + "\n" for w in "aba"))
    record = TPW.persistence.Config(backend=TPW.persistence.Backend.filesystem(
        str(tmp_path / "rec")), snapshot_access="record")
    import runpy

    with t_run.persistence_default(record):
        import sys

        argv, sys.argv = sys.argv, [str(prog), str(src), str(tmp_path / "o1.jsonl")]
        try:
            runpy.run_path(str(prog), run_name="__main__")
        finally:
            sys.argv = argv
    recorded = {e["word"]: e["c"] for e in _entries(tmp_path / "o1.jsonl") if e["diff"] > 0}
    assert recorded == {"a": 2, "b": 1}
    (src / "d.jsonl").unlink()
    TPW.clear_graph()
    assert cli.main(["replay", "--record-path", str(tmp_path / "rec"), str(prog), str(src),
                     str(tmp_path / "o2.jsonl")]) == 0
    replayed = {e["word"]: e["c"] for e in _entries(tmp_path / "o2.jsonl") if e["diff"] > 0}
    assert replayed == recorded
    assert t_run._DEFAULT_PERSISTENCE is None


# ------------------------------------------------------------ isolation


def test_stores_do_not_cross_packages(tmp_path):
    """The port refuses a JAX store (no header) and any JAX class in a
    store; a port store names no JAX class and no tensor storage; JAX
    cannot read a port store's metadata."""
    src = tmp_path / "src"
    src.mkdir()
    _write_csv(src / "a.csv", ["cat"])
    _wordcount("jax", src, tmp_path / "o1.jsonl", tmp_path / "jax-store")
    with pytest.raises(ForeignStoreError):
        TPW.persistence.PersistenceManager(_fs_cfg("torch", tmp_path / "jax-store"))
    from pathway_tpu_torch.engine.state import STORE_MAGIC

    with pytest.raises(pickle.UnpicklingError):
        place_state(STORE_MAGIC + pickle.dumps(JPW.Json({"a": 1})))
    _wordcount("torch", src, tmp_path / "o2.jsonl", tmp_path / "port-store")
    b = TPW.persistence.FilesystemBackend(tmp_path / "port-store")
    for key in b.list_keys():
        blob = b.get_value(key)
        assert blob.startswith(STORE_MAGIC)
        assert b"pathway_tpu." not in blob.replace(b"pathway_tpu_torch.", b"")
        assert b"torch._utils" not in blob
    with pytest.raises(pickle.UnpicklingError):
        JPW.persistence.MetadataAccessor(JPW.persistence.FilesystemBackend(
            tmp_path / "port-store"), 0)
