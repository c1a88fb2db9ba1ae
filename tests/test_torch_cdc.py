"""The port's change-stream readers held against the JAX package on the
same inputs: ``pw.io.debezium`` (create / update / delete envelopes, the
same batch netting to nothing, snapshot reads, a flattened envelope, a
malformed one skipped and logged, the stubbed ``confluent_kafka``
transport; ``tests/test_cdc_async_matrix.py``, ``tests/test_real_backends.py``),
``pw.io.sqlite`` (static, and streaming while a writer commits), and
``pw.io.deltalake`` on JAX's stub tables (snapshot diff, change data feed,
a primary key's upserts; ``tests/test_io_backends.py:279-435``). Row ids
must be equal across the packages and the update streams equal.
``persistent_id`` resumes Debezium and the object store exactly once in
both (``tests/test_real_backends.py:538``, ``:635``).

The race of a reader closed while its first read runs is driven through
both packages: the commit of the first read is held until a stopper has
called ``c._stop.set(); c.close()``. Both drop that read (the source is
closed before its commit lands, and the run ends without it); the port
keeps JAX's behaviour, pinned here. Every wait is bounded."""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from importlib import import_module

import pytest

from tests.test_io_backends import _CdfStubDeltaTable, _StubDeltaTable
from tests.test_real_backends import (
    _DictProvider,
    _StubConsumer,
    _StubMessage,
    stub_confluent,  # noqa: F401 - fixture
)
from tests.torch_engine import PACKAGES, PW, canon, final_state

pytestmark = pytest.mark.timeout(120)

WAIT = 20.0


@pytest.fixture(autouse=True)
def _clean():
    yield
    from pathway_tpu.internals import config as j_config

    j_config.set_persistence_config(None)
    for pw in PW.values():
        pw.clear_graph()


def _kv(pw):
    class KV(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    return KV


def _cdc(op, before=None, after=None):
    return json.dumps({"payload": {"op": op, "before": before, "after": after}}).encode()


def _wait(cond, deadline):
    while time.time() < deadline and not cond():
        time.sleep(0.02)


def _stream(pkg, build, done, feed=None, stop_only=False, timeout=WAIT):
    """``(row id, row, is_addition)`` events of ``build(pw)``'s table in a
    streaming run while ``feed(wait_for)`` runs; the connectors stop once
    ``done(events)`` (``stop_only``: ``_stop`` alone, the reader ends its
    pass and closes itself)."""
    pw = PW[pkg]
    pw.clear_graph()
    t = build(pw)
    events, lock = [], threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            events.append((key.value, tuple(canon(v) for v in row.values()), is_addition))

    pw.io.subscribe(t, on_change=on_change)
    conns = list(pw.G.connectors)

    def feeder():
        deadline = time.time() + timeout
        try:
            if feed is not None:
                feed(lambda n: _wait(lambda: len(events) >= n, deadline))
            _wait(lambda: done(list(events)), deadline)
        finally:
            for c in conns:
                c._stop.set()
                if not stop_only:
                    c.close()

    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    pw.run()
    th.join(timeout)
    assert not th.is_alive(), "the feeder did not finish"
    return events


def _net(events):
    net = {}
    for k, row, add in events:
        net[(k, row)] = net.get((k, row), 0) + (1 if add else -1)
    return {kr: n for kr, n in net.items() if n}


# ------------------------------------------------------------------ Debezium
def test_debezium_create_update_delete_sequence():
    """Each envelope in its own poll: the intermediate states show, in
    order, under one row id."""
    out = {}
    for pkg in PACKAGES:
        broker = PW[pkg].io.kafka.InMemoryKafkaBroker()

        def feed(wait_for, broker=broker):
            broker.produce("cdc", _cdc("c", after={"k": "a", "v": 1}))
            wait_for(1)
            broker.produce("cdc", _cdc("u", before={"k": "a", "v": 1},
                                       after={"k": "a", "v": 2}))
            wait_for(3)
            broker.produce("cdc", _cdc("d", before={"k": "a", "v": 2}))

        out[pkg] = _stream(pkg, lambda pw, b=broker: pw.io.debezium.read(b, "cdc",
                                                                        schema=_kv(pw)),
                           lambda ev: len(ev) >= 4, feed)
    assert out["torch"] == out["jax"]
    assert [(r, a) for _k, r, a in out["torch"]] == [
        (("a", 1), True), (("a", 1), False), (("a", 2), True), (("a", 2), False)]
    assert len({k for k, _r, _a in out["torch"]}) == 1


@pytest.mark.parametrize("case", ["same_batch", "snapshot_read", "flattened", "malformed"])
def test_debezium_closed_broker_cases(case):
    msgs = {
        "same_batch": [_cdc("c", after={"k": "a", "v": 1}),
                       _cdc("u", before={"k": "a", "v": 1}, after={"k": "a", "v": 2}),
                       _cdc("d", before={"k": "a", "v": 2})],
        "snapshot_read": [_cdc("r", after={"k": "x", "v": 7}),
                          _cdc("c", after={"k": "y", "v": 8})],
        "flattened": [json.dumps({"op": "c", "after": {"k": "z", "v": 3}}).encode()],
        "malformed": [b"not json {", b"[1, 2]", _cdc("c", after={"k": "ok", "v": 1})],
    }[case]
    want = {"same_batch": [], "snapshot_read": [("x", 7), ("y", 8)],
            "flattened": [("z", 3)], "malformed": [("ok", 1)]}[case]
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        log = pw.internals.errors.get_global_error_log()
        before = len(log.entries)
        broker = pw.io.kafka.InMemoryKafkaBroker()
        for m in msgs:
            broker.produce("cdc", m)
        broker.close()  # the reader ends by itself once the log is drained
        pw.clear_graph()
        t = pw.io.debezium.read(broker, "cdc", schema=_kv(pw))
        rows, _ = final_state(pkg, t)
        skipped = [e for e in log.entries[before:] if "malformed CDC" in e["message"]]
        out[pkg] = (rows, len(skipped))
    assert out["torch"] == out["jax"]
    assert sorted(out["torch"][0].values()) == want
    assert out["torch"][1] == (2 if case == "malformed" else 0)


def test_debezium_real_kafka_transport(stub_confluent):  # noqa: F811
    def dbz(op, before=None, after=None):
        return _cdc(op, before, after)

    out = {}
    for pkg in PACKAGES:
        _StubConsumer.MESSAGES = [
            _StubMessage(dbz("c", after={"id": 1, "word": "a"}), 0, 0),
            _StubMessage(dbz("c", after={"id": 2, "word": "b"}), 0, 1),
            _StubMessage(dbz("u", before={"id": 1, "word": "a"},
                             after={"id": 1, "word": "a2"}), 0, 2),
            _StubMessage(dbz("d", before={"id": 2, "word": "b"}), 0, 3),
        ]

        def build(pw):
            class IdWord(pw.Schema):
                id: int = pw.column_definition(primary_key=True)
                word: str

            return pw.io.debezium.read({"bootstrap.servers": "stub:9092"}, "cdc",
                                       schema=IdWord)

        events = _stream(pkg, build, lambda ev: list(
            r for (_k, r), n in _net(ev).items()) == [(1, "a2")])
        out[pkg] = _net(events)
    assert out["torch"] == out["jax"]
    assert [r for (_k, r) in out["torch"]] == [(1, "a2")]


def test_debezium_persistent_restart_exactly_once(tmp_path):
    """Two runs over one broker with ``persistent_id``: the second replays
    the first's live map and reads only what came after (an update of a
    replayed key retracts its replayed value)."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        broker = pw.io.kafka.InMemoryKafkaBroker()
        broker.produce("cdc", _cdc("c", after={"k": "a", "v": 1}))
        broker.produce("cdc", _cdc("c", after={"k": "b", "v": 2}))
        store = tmp_path / f"store-{pkg}"
        runs = []
        for expect, extra in ((2, []), (4, [_cdc("u", before={"k": "a", "v": 1},
                                                 after={"k": "a", "v": 5}),
                                            _cdc("c", after={"k": "c", "v": 3})])):
            for m in extra:
                broker.produce("cdc", m)
            import_module(f"{pw.__name__}.persistence")._persistent_sources.clear()
            runs.append(_persistent_run(
                pkg, store, lambda pw, b=broker: pw.io.debezium.read(
                    b, "cdc", schema=_kv(pw), persistent_id="dbz"),
                lambda ev, n=expect: len(ev) >= n))
        out[pkg] = runs
    assert out["torch"] == out["jax"]
    first, second = out["torch"]
    assert sorted(r for (_k, r) in _net(first)) == [("a", 1), ("b", 2)]
    assert sorted(r for (_k, r) in _net(second)) == [("a", 5), ("b", 2), ("c", 3)]
    assert all(n == 1 for n in _net(second).values())


def _persistent_run(pkg, store, build, done):
    pw = PW[pkg]
    cfg = pw.persistence.Config(backend=pw.persistence.Backend.filesystem(str(store)))
    if pkg == "jax":
        from pathway_tpu.internals import config as j_config

        j_config.set_persistence_config(cfg)
        try:
            return _stream(pkg, build, done)
        finally:
            j_config.set_persistence_config(None)
    pw.clear_graph()
    t = build(pw)
    events, lock = [], threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            events.append((key.value, tuple(canon(v) for v in row.values()), is_addition))

    pw.io.subscribe(t, on_change=on_change)
    conns = list(pw.G.connectors)

    def stopper():
        deadline = time.time() + WAIT
        _wait(lambda: done(list(events)), deadline)
        for c in conns:
            c._stop.set()
            c.close()

    th = threading.Thread(target=stopper, daemon=True)
    th.start()
    pw.run(persistence_config=cfg)
    th.join(WAIT)
    return events


def test_object_store_persistent_restart_no_refetch_no_dupes(tmp_path):
    """JAX's kill/restart shape: a restarted static read re-emits nothing
    twice and fetches nothing unchanged (the cache and the offsets); a
    changed object is re-read and retracts its old row."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        provider = _DictProvider({"a": (1, b"alpha"), "b": (1, b"beta")})
        store = tmp_path / f"store-{pkg}"
        runs = []
        for step in range(3):
            if step == 1:
                provider.fetches.clear()
            if step == 2:
                provider.objects["a"] = (2, b"alpha2")
            import_module(f"{pw.__name__}.persistence")._persistent_sources.clear()
            cfg = pw.persistence.Config(
                backend=pw.persistence.Backend.filesystem(str(store)))
            pw.clear_graph()
            t = pw.io.pyfilesystem.read(None, mode="static", persistent_id="objs",
                                        _provider=provider)
            events = []
            pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, ev=events:
                            ev.append((key.value, row["data"], is_addition)))
            if pkg == "jax":
                from pathway_tpu.internals import config as j_config

                j_config.set_persistence_config(cfg)
                try:
                    pw.run()
                finally:
                    j_config.set_persistence_config(None)
            else:
                pw.run(persistence_config=cfg)
            runs.append((events, list(provider.fetches)))
        out[pkg] = runs
    assert out["torch"] == out["jax"]
    (first, _), (second, fetches2), (third, _) = out["torch"]
    nets = [_net([(k, (d,), a) for k, d, a in ev]) for ev in (first, second, third)]
    assert sorted(r for (_k, r) in nets[0]) == [(b"alpha",), (b"beta",)]
    assert nets[1] == nets[0] and all(n == 1 for n in nets[1].values())
    assert fetches2 == []
    assert sorted(r for (_k, r) in nets[2]) == [(b"alpha2",), (b"beta",)]


# -------------------------------------------------------------------- SQLite
def _words_db(path, rows):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE words (word TEXT PRIMARY KEY, n INTEGER)")
    conn.executemany("INSERT INTO words VALUES (?, ?)", rows)
    conn.commit()
    conn.close()


def _wn(pw, pk=False):
    if pk:
        class PkWN(pw.Schema):
            word: str = pw.column_definition(primary_key=True)
            n: int

        return PkWN

    class WN(pw.Schema):
        word: str
        n: int

    return WN


@pytest.mark.parametrize("pk", [False, True])
def test_sqlite_static(tmp_path, pk):
    db = tmp_path / "x.db"
    _words_db(db, [("cat", 1), ("dog", 2)])
    out = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        out[pkg] = final_state(pkg, PW[pkg].io.sqlite.read(str(db), "words",
                                                            _wn(PW[pkg], pk), mode="static"))
    assert out["torch"] == out["jax"]
    assert sorted(out["torch"][0].values()) == [("cat", 1), ("dog", 2)]


def test_sqlite_streaming_follows_commits(tmp_path):
    """A writer commits an update, a delete and an insert after the first
    poll; the reader's next poll retracts and inserts under the same row
    ids in both packages, and a ``_stop`` alone ends it."""
    out = {}
    for pkg in PACKAGES:
        db = tmp_path / f"s-{pkg}.db"
        _words_db(db, [("cat", 1), ("dog", 2), ("eel", 3)])

        def feed(wait_for, db=db):
            wait_for(3)
            conn = sqlite3.connect(db)
            conn.execute("UPDATE words SET n = 10 WHERE word = 'cat'")
            conn.execute("DELETE FROM words WHERE word = 'dog'")
            conn.execute("INSERT INTO words VALUES ('fox', 4)")
            conn.commit()
            conn.close()

        events = _stream(pkg, lambda pw, db=db: pw.io.sqlite.read(
            str(db), "words", _wn(pw, pk=True), mode="streaming"),
            lambda ev: len(ev) >= 7, feed, stop_only=True)
        out[pkg] = (events[:3], sorted(events[3:]), _net(events))
    assert out["torch"][0] == out["jax"][0] and out["torch"][1] == out["jax"][1]
    assert sorted(r for (_k, r) in out["torch"][2]) == [("cat", 10), ("eel", 3), ("fox", 4)]


# ---------------------------------------------------------------- Delta Lake
def _dl_schema(pw, pk=False):
    if pk:
        class PkDl(pw.Schema):
            word: str = pw.column_definition(primary_key=True)
            n: int

        return PkDl

    class Dl(pw.Schema):
        word: str
        n: int

    return Dl


def _delta(case):
    """(stub table maker, feed(table, wait_for), events to wait for, pk)."""
    import pandas as pd

    if case == "versions":
        def feed(table, wait_for):
            wait_for(1)
            table.append({"word": ["b"], "n": [2]})
            wait_for(2)
            table.append({"word": ["c"], "n": [3]})

        return lambda: _StubDeltaTable([{"word": ["a"], "n": [1]}]), feed, 3, False
    if case == "snapshot_diff":
        def feed(table, wait_for):
            wait_for(2)
            table._frames.append(pd.DataFrame({"word": ["a", "c"], "n": [1, 3]}))
            table.loaded_version = 1

        return lambda: _StubDeltaTable([{"word": ["a", "b"], "n": [1, 2]}]), feed, 4, False
    if case == "cdf":
        cdf = {1: [
            {"word": "b", "n": 2, "_change_type": "insert", "_commit_version": 1},
            {"word": "a", "n": 1, "_change_type": "update_preimage", "_commit_version": 1},
            {"word": "a", "n": 10, "_change_type": "update_postimage",
             "_commit_version": 1},
        ]}

        def feed(table, wait_for):
            wait_for(1)
            table._frames.append(pd.DataFrame({"word": ["a", "b"], "n": [10, 2]}))

        return (lambda: _CdfStubDeltaTable([{"word": ["a"], "n": [1]}], cdf=cdf), feed,
                4, False)

    def feed(table, wait_for):  # upsert: a primary key over snapshot diffs
        wait_for(2)
        table._frames.append(pd.DataFrame({"word": ["a", "c"], "n": [5, 3]}))
        table.loaded_version = 1

    return lambda: _StubDeltaTable([{"word": ["a", "b"], "n": [1, 2]}]), feed, 6, True


@pytest.mark.parametrize("case", ["versions", "snapshot_diff", "cdf", "upsert"])
def test_deltalake_streaming(case):
    make, feed, n, pk = _delta(case)
    out = {}
    for pkg in PACKAGES:
        table = make()
        events = _stream(pkg, lambda pw, table=table: pw.io.deltalake.read(
            "mem://dl", _dl_schema(pw, pk), mode="streaming", refresh_interval=0.02,
            _table=table), lambda ev: len(ev) >= n,
            lambda wait_for, table=table: feed(table, wait_for))
        out[pkg] = sorted(events)
    assert out["torch"] == out["jax"]
    signed = sorted((r, 1 if a else -1) for _k, r, a in out["torch"])
    assert signed == {
        "versions": [(("a", 1), 1), (("b", 2), 1), (("c", 3), 1)],
        "snapshot_diff": [(("a", 1), 1), (("b", 2), -1), (("b", 2), 1), (("c", 3), 1)],
        "cdf": [(("a", 1), -1), (("a", 1), 1), (("a", 10), 1), (("b", 2), 1)],
        "upsert": [(("a", 1), -1), (("a", 1), 1), (("a", 5), 1), (("b", 2), -1),
                   (("b", 2), 1), (("c", 3), 1)],
    }[case]


def test_deltalake_static_reads_current_snapshot():
    out = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        table = _StubDeltaTable([{"word": ["x", "y"], "n": [7, 8]}])
        out[pkg] = final_state(pkg, PW[pkg].io.deltalake.read(
            "mem://dl", _dl_schema(PW[pkg]), mode="static", _table=table))
    assert out["torch"] == out["jax"]
    assert sorted(out["torch"][0].values()) == [("x", 7), ("y", 8)]


# ------------------------------------------- a reader closed in its first read
def _race_build(kind, tmp_path):
    if kind == "fs":
        src = tmp_path / "race-src"
        src.mkdir(exist_ok=True)
        (src / "a.jsonl").write_text(json.dumps({"word": "x", "n": 1}) + "\n")
        return lambda pw: pw.io.jsonlines.read(str(src), schema=_wn(pw), mode="streaming",
                                               refresh_interval=0.05)
    db = tmp_path / "race.db"
    if not db.exists():
        _words_db(db, [("x", 1)])
    return lambda pw: pw.io.sqlite.read(str(db), "words", _wn(pw, pk=True),
                                        mode="streaming")


@pytest.mark.parametrize("kind", ["fs", "sqlite"])
def test_close_during_first_read_matches_jax(kind, tmp_path):
    """``c._stop.set(); c.close()`` from another thread while the first
    read runs: the read's commit is held until the close has landed and
    the scheduler has seen its source gone. JAX drops the read, and so
    does the port: the source closed under the read, and the run ended
    before its commit."""
    build = _race_build(kind, tmp_path)
    got = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = build(pw)
        seen = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row))
        (conn,) = pw.G.connectors
        reading, closed = threading.Event(), threading.Event()
        commit = conn.commit_rows

        def held_commit(rows, commit=commit, reading=reading, closed=closed):
            if not reading.is_set():
                reading.set()
                closed.wait(WAIT)
            return commit(rows)

        conn.commit_rows = held_commit

        def stopper(conn=conn, reading=reading, closed=closed):
            reading.wait(WAIT)
            conn._stop.set()
            conn.close()
            time.sleep(0.2)  # the scheduler sees no live source and ends
            closed.set()

        th = threading.Thread(target=stopper, daemon=True)
        th.start()
        pw.run()
        th.join(WAIT)
        assert reading.is_set() and closed.is_set()
        got[pkg] = list(seen)
    assert got["torch"] == got["jax"] == []
