"""Exported tables in the port (``internals/exported.py``) held against
the JAX package: the cases of ``tests/test_exported.py`` on both packages
(a snapshot after a run, one at an earlier frontier, an import into a
second graph with its row ids, the live handoff between running graphs,
an import that follows a finished export, compaction), then what only the
port carries: rows with tensor or ndarray cells consolidate by their
bytes. JAX hashes the row tuple, so its ``snapshot_at`` refuses an
ndarray cell (pinned below) and keys a tensor by identity; the port's
``snapshot_at``, ``consistent_handoff`` and compaction cancel a retraction
against an insertion holding an equal copy. The small test encoder behind
the deferred embed UDF, fed by Debezium creates, updates and deletes,
exports a snapshot equal to JAX's final table within 1e-4, with no
retracted row. Every wait is bounded."""

from __future__ import annotations

import json
import threading
import time
from importlib import import_module

import numpy as np
import pytest
import torch

from tests.torch_engine import PACKAGES, PW, canon, final_state

pytestmark = pytest.mark.timeout(120)

WAIT = 20.0


@pytest.fixture(autouse=True)
def _clean():
    yield
    for pw in PW.values():
        pw.clear_graph()


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _canon_rows(rows):
    return sorted((k, tuple(canon(v) for v in r)) for k, r in rows)


def _each(build):
    """``build(pw)`` in each package; the two results equal."""
    out = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        out[pkg] = build(PW[pkg])
    assert out["torch"] == out["jax"]
    return out["torch"]


# ------------------------------------------------ tests/test_exported.py
def test_export_snapshot_after_run():
    def build(pw):
        exported = pw.export_table(_md(pw, """
            a | b
            1 | x
            2 | y
            """))
        pw.run()
        return _canon_rows(exported.snapshot_at(exported.frontier()))

    rows = _each(build)
    assert sorted(r for _k, r in rows) == [(1, "x"), (2, "y")]


def test_snapshot_at_earlier_frontier_excludes_later_updates():
    def build(pw):
        exported = pw.export_table(_md(pw, """
            a | __time__ | __diff__
            1 | 2        | 1
            2 | 4        | 1
            1 | 6        | -1
            """))
        pw.run()
        return (_canon_rows(exported.snapshot_at(exported.frontier())),
                _canon_rows(exported.snapshot_at(4)))

    full, early = _each(build)
    assert [r for _k, r in full] == [(2,)]
    assert sorted(r for _k, r in early) == [(1,), (2,)]


def test_import_into_second_graph_preserves_keys():
    def build(pw):
        t = _md(pw, """
              | a
            7 | 1
            8 | 2
            """)
        exported = pw.export_table(t.select(a=t.a * 10))
        pw.run()
        pw.clear_graph()
        imported = pw.import_table(exported, follow=False)
        rows, _ = final_state("torch" if pw is PW["torch"] else "jax",
                              imported.select(b=imported.a + 1))
        return rows, sorted(k for k, _r in exported.snapshot_at(exported.frontier()))

    rows, keys = _each(build)
    assert sorted(rows.values()) == [(11,), (21,)] and sorted(rows) == keys


def test_import_follow_terminates_when_source_finished():
    def build(pw):
        exported = pw.export_table(_md(pw, """
            a
            5
            """))
        pw.run()
        assert exported.finished
        pw.clear_graph()
        imported = pw.import_table(exported)  # follow=True must still terminate
        got = []
        pw.io.subscribe(imported, on_change=lambda key, row, time, is_addition:
                        got.append((key.value, row["a"])))
        start = time.time()
        pw.run()
        assert time.time() - start < 30
        return got

    assert [a for _k, a in _each(build)] == [5]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_live_follow_between_running_graphs(pkg, tmp_path):
    """Graph A streams while a reader takes the handoff: the snapshot, then
    an update arriving after it, on the queue."""
    pw = PW[pkg]
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jsonl").write_text(json.dumps({"word": "one"}) + "\n")

    class S(pw.Schema):
        word: str

    pw.clear_graph()
    t = pw.io.jsonlines.read(str(src), schema=S, mode="streaming", refresh_interval=0.05)
    exported = pw.export_table(t)
    conns = list(pw.G.connectors)
    seen = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row))
    thread_a = threading.Thread(target=pw.run, daemon=True)
    thread_a.start()
    try:
        deadline = time.time() + WAIT
        while time.time() < deadline and not seen:
            time.sleep(0.02)
        _frontier, rows, updates = exported.consistent_handoff()
        assert [r[1][0] for r in rows] == ["one"]
        (src / "b.jsonl").write_text(json.dumps({"word": "two"}) + "\n")
        got = updates.get(timeout=WAIT)
        assert got[2][0] == "two" and got[3] == 1
    finally:
        for c in conns:
            c._stop.set()
            c.close()
        thread_a.join(WAIT)
    assert not thread_a.is_alive()


def test_export_history_compaction_bounds_memory():
    def build(pw):
        exp_mod = import_module(f"{pw.__name__}.internals.exported")
        exported = pw.export_table(_md(pw, """
            a
            1
            """))
        pw.run()
        with exported._lock:
            for i in range(exp_mod._COMPACT_THRESHOLD + 100):
                exported._history.append((2, i, (i,), 1))
                exported._history.append((2, i, (i,), -1))
            exported._frontier = 2
            exported._compact_locked()
        return len(exported._history), _canon_rows(exported.snapshot_at(2))

    n, rows = _each(build)
    assert n <= 10 and [r for _k, r in rows] == [(1,)]


# ------------------------------------------------- array cells, by bytes
def test_jax_consolidation_refuses_an_ndarray_cell():
    """Why the port compares by bytes: JAX's ``snapshot_at`` hashes the row
    tuple and raises on an ndarray; the port's consolidates it."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int, v=np.ndarray),
                                     [(1, np.ones(3)), (2, np.zeros(3))])
        exported = pw.export_table(t)
        pw.run()
        try:
            out[pkg] = _canon_rows(exported.snapshot_at(exported.frontier()))
        except TypeError as exc:
            out[pkg] = exc
    assert isinstance(out["jax"], TypeError) and "unhashable" in str(out["jax"])
    assert [r[0] for _k, r in out["torch"]] == [1, 2]


def _tensor_history(exported, n):
    """Insert n tensor rows at time 2, then update each at time 4: the
    retraction holds a distinct tensor object with equal bytes (as when a
    row is handed over as a copy), the insertion a new value."""
    with exported._lock:
        for i in range(n):
            exported._history.append((2, i, (i, torch.full((4,), float(i))), 1))
        for i in range(n):
            exported._history.append((4, i, (i, torch.full((4,), float(i))), -1))
            exported._history.append((4, i, (i, torch.full((4,), float(i) + 0.5)), 1))
        exported._frontier = 4


def _values(rows):
    return sorted((k, r[0], r[1].tolist()) for k, r in rows)


def test_tensor_cells_consolidate_in_snapshot_handoff_and_compaction():
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import exported as exp_mod

    pw.clear_graph()
    exported = pw.export_table(pw.debug.table_from_rows(
        pw.schema_from_types(a=int, v=torch.Tensor), []))
    pw.run()
    _tensor_history(exported, 8)
    want = [(i, i, [i + 0.5] * 4) for i in range(8)]
    assert _values(exported.snapshot_at(4)) == want
    assert _values(exported.snapshot_at(2)) == [(i, i, [float(i)] * 4) for i in range(8)]
    frontier, rows, updates = exported.consistent_handoff()
    assert frontier == 4 and _values(rows) == want and updates.get_nowait() is exp_mod._FINISHED
    # compaction over tensor rows: every update pair cancels by bytes
    n = exp_mod._COMPACT_THRESHOLD // 2 + 10
    with exported._lock:
        exported._history = []
    _tensor_history(exported, n)
    with exported._lock:
        exported._compact_locked()
        assert len(exported._history) == n
    assert _values(exported.snapshot_at(4)) == [(i, i, [i + 0.5] * 4) for i in range(n)]
    assert exported.compactions == 1


def test_trickled_updates_hash_each_entry_a_bounded_number_of_times(monkeypatch):
    """A live set above the threshold fed one update a batch: a compaction
    waits for twice the rows the last one left, so the rows consolidated
    stay within a small multiple of the entries (compacting at every batch,
    as JAX does, would hash the whole live set a batch: ~100x here)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.batch import Batch
    from pathway_tpu_torch.internals import exported as exp_mod
    from pathway_tpu_torch.persistence.snapshot import row_identities

    hashed = []

    def counting(rows):
        hashed.append(len(rows))
        return row_identities(rows)

    monkeypatch.setattr(exp_mod, "_COMPACT_THRESHOLD", 50)
    monkeypatch.setattr(exp_mod, "row_identities", counting)
    pw.clear_graph()
    exported = pw.export_table(pw.debug.table_from_rows(
        pw.schema_from_types(a=int, v=torch.Tensor), []))
    write = pw.G.sinks[-1].write_batch
    live, n_upd = 100, 1000
    write(2, Batch.from_rows(["a", "v"], [(i, (i, torch.full((4,), 0.0)), 1)
                                          for i in range(live)]))
    for u in range(n_upd):
        i = u % live
        write(4 + u, Batch.from_rows(["a", "v"], [
            (i, (i, torch.full((4,), float(u // live))), -1),
            (i, (i, torch.full((4,), float(u // live + 1))), 1)]))
    entries = live + 2 * n_upd
    assert exported.compactions >= 10 and sum(hashed) <= 3 * entries
    assert len(exported._history) <= 2 * live + 2
    assert _values(exported.snapshot_at(exported.frontier())) == [
        (i, i, [float(n_upd // live)] * 4) for i in range(live)]
    pw.clear_graph()


def test_row_identities_equal_cells_equal_identities():
    """Equal cells give equal identities whatever the object (host tensors
    are read in place: only CUDA cells are joined into one copy a device,
    which phase 23 of ``chip_smoke.py`` drives on the card)."""
    from pathway_tpu_torch.persistence.snapshot import row_identities

    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    rows = [(1, a.clone()), (1, a.clone()), (1, a + 1), (2, np.ones(2)), (2, np.ones(2)),
            ("x", [torch.ones(2)]), ("x", [torch.ones(2)])]
    calls = []
    orig = torch.cat

    def counting_cat(ts, *args, **kw):
        calls.append(len(ts))
        return orig(ts, *args, **kw)

    torch.cat = counting_cat
    try:
        ids = row_identities(rows)
    finally:
        torch.cat = orig
    assert ids[0] == ids[1] and ids[0] != ids[2] and ids[3] == ids[4] and ids[5] == ids[6]
    assert calls == [] and all(hash(i) is not None for i in ids)
    assert row_identities([(1, "a")]) == [(1, "a")]


def test_import_of_tensor_rows_into_a_second_graph():
    """An import takes the consolidated tensor rows: each key once, at its
    updated value."""
    import pathway_tpu_torch as pw

    pw.clear_graph()
    exported = pw.export_table(pw.debug.table_from_rows(
        pw.schema_from_types(a=int, v=torch.Tensor), []))
    pw.run()
    _tensor_history(exported, 4)
    pw.clear_graph()
    cap = pw.debug.table_to_dicts(pw.import_table(exported))[1]
    assert sorted((int(k), cap["a"][k], cap["v"][k].tolist()) for k in cap["a"]) == [
        (i, i, [i + 0.5] * 4) for i in range(4)]


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
    jm = JEmbed(jcfg, params=to_jax(npp), tokenizer=JTok(vocab_size=1000, max_length=32),
                max_length=32)
    tm = SentenceEmbedderModel(tcfg, params=from_jax_params(npp),
                               tokenizer=HashTokenizer(vocab_size=1000, max_length=32),
                               max_length=32, device="cpu")
    yield {"jax": jm, "torch": tm}
    jm.close()
    tm.close()


def _cdc(op, before=None, after=None):
    return json.dumps({"payload": {"op": op, "before": before, "after": after}}).encode()


def test_embed_udf_export_with_update_and_delete(encoders):
    """Debezium -> deferred embed UDF -> export: 24 creates, then 4 updates
    and 4 deletes in a later poll. The port's snapshot keeps 20 rows, none
    retracted, equal to JAX's final table (row ids, texts; vectors within
    1e-4), and its handoff plus queued updates equal it too."""
    rng = np.random.default_rng(3)
    words = ["alpha", "beta", "gamma", "delta", "index", "stream"]
    texts = {i: " ".join(rng.choice(words, 5)) for i in range(24)}
    new = {i: " ".join(rng.choice(words, 5)) for i in range(4)}
    finals = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        mod = import_module(f"{pw.__name__}.xpacks.llm.embedders")
        kw = {"dedup": False} if pkg == "torch" else {}
        emb = mod.SentenceTransformerEmbedder(encoders[pkg], max_batch_size=8, deferred=True,
                                              **kw)

        class Doc(pw.Schema):
            doc_id: int = pw.column_definition(primary_key=True)
            text: str

        pw.clear_graph()
        broker = pw.io.kafka.InMemoryKafkaBroker()
        for i, t in texts.items():
            broker.produce("docs", _cdc("c", after={"doc_id": i, "text": t}))
        docs = pw.io.debezium.read(broker, "docs", schema=Doc)
        vecs = docs.select(docs.doc_id, docs.text, vec=emb(docs.text))
        exported = pw.export_table(vecs) if pkg == "torch" else None
        live, lock = {}, threading.Lock()

        def on_change(key, row, time, is_addition, live=live, lock=lock):
            with lock:
                if is_addition:
                    live[key.value] = (row["doc_id"], row["text"], np.asarray(row["vec"]))
                else:
                    live.pop(key.value, None)

        pw.io.subscribe(vecs, on_change=on_change)

        def feed(broker=broker, live=live, lock=lock):
            deadline = time.time() + WAIT
            while time.time() < deadline:
                with lock:
                    if len(live) >= 24:
                        break
                time.sleep(0.02)
            for i in range(4):
                broker.produce("docs", _cdc("u", before={"doc_id": i, "text": texts[i]},
                                            after={"doc_id": i, "text": new[i]}))
            for i in range(20, 24):
                broker.produce("docs", _cdc("d", before={"doc_id": i, "text": texts[i]}))
            broker.close()  # the reader drains the log and ends

        th = threading.Thread(target=feed, daemon=True)
        th.start()
        pw.run()
        th.join(WAIT)
        finals[pkg] = dict(live)
        if pkg == "torch":
            snap = exported.snapshot_at(exported.frontier())
            _frontier, rows, updates = exported.consistent_handoff()
        getattr(emb, "close", lambda: None)()
    want = {i: new.get(i, texts[i]) for i in range(20)}
    for pkg in PACKAGES:
        assert {d: t for d, t, _v in finals[pkg].values()} == want
    assert sorted(finals["torch"]) == sorted(finals["jax"])
    got = {k: r for k, r in snap}
    assert len(snap) == 20 and sorted(got) == sorted(finals["jax"])
    for k, (doc, text, vec) in got.items():
        jdoc, jtext, jvec = finals["jax"][k]
        assert (doc, text) == (jdoc, jtext)
        np.testing.assert_allclose(np.asarray(vec), jvec, atol=1e-4, rtol=0)
    assert _canon_rows(rows) == _canon_rows(snap)


@pytest.mark.timeout(180)
def test_phase23_slice_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 23 at a small size on the CPU: 256 Debezium
    creates with 32 updates and 16 deletes in commits of 16, 64 sqlite rows
    with 8 updates and 4 deletes, the small test encoder in f32, 8 queries,
    the export compacting past 200 history entries. Every bar of the chip
    phase but the kernel launch counts, which the CPU does not make."""
    import chip_smoke as cs
    import pathway_tpu_torch as TPW
    from pathway_tpu_torch.internals import exported as exp_mod
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.models.transformer import TransformerConfig
    from pathway_tpu_torch.xpacks import llm
    from tests.torch_parity import SMALL, np_encoder_params

    monkeypatch.setattr(exp_mod, "_COMPACT_THRESHOLD", 200)
    docs, queries = cs.corpus(n_queries=8)
    model = SentenceEmbedderModel(TransformerConfig(**SMALL, dtype=torch.float32),
                                  params=from_jax_params(np_encoder_params(seed=4)),
                                  tokenizer=HashTokenizer(vocab_size=SMALL["vocab_size"],
                                                          max_length=64),
                                  max_length=64, device="cpu")
    spec = cs.p23_spec(dbz=256, sql=64, upd=32, sql_upd=8, sql_del=4, chunk=16,
                       handoff_at=64, batch=64, knn={"device": "cpu"}, timeout=60.0,
                       tensor_rows=200,
                       **{"del": 16})
    try:
        out = cs.p23_phase(TPW, llm, model, spec, docs, queries, str(tmp_path), "cpu")
    finally:
        TPW.clear_graph()
        model.close()
    assert out["launches"] == 0 and out["encodes"] > 8  # the CPU launches no kernel
    assert out["compactions"] >= 1 and out["agree"] == 8 and out["sim_agree"] == 8
    assert out["n_events"] == 256 + 48 + 64 + 12
