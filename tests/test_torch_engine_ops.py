"""The port's dataflow engine held against the JAX package's, program by
program: the same seeded delta streams go through both packages' Table
API, and the final tables (row ids and values) and the subscribe update
streams (row id, row, time, is_addition; in order) must be equal.

The cases are those of ``tests/test_incremental_equivalence.py`` whose
operators the port carries (select/filter, groupby/reduce, global reduce,
concat + groupby, distinct, the level-parallel scheduler),
``tests/test_fusion.py`` (fused equals unfused),
``tests/test_engine_closeout.py`` (columnar subscribe order, each close-out
switch off keeps results) and ``tests/test_streaming_semantics.py``'s
groupby-count, filter, union and on_time_end streams. Every streaming wait
is bounded by a deadline."""

import random
import threading
import time as _t

import numpy as np
import pytest

from pathway_tpu_torch.engine.batch import Batch, consolidate
from tests.torch_engine import (
    PACKAGES,
    PW,
    engine_flags,
    final_state,
    last_run_stats,
    update_stream,
)

KDOM = ["a", "b", "c", "d", "e"]


def _gen_events(rng: random.Random, n: int, vmax: int = 20):
    """Valid delta stream over (k: str, v: int): every retraction targets a
    live row, so every prefix is a valid collection."""
    live: list[tuple] = []
    events = []
    for _ in range(n):
        if live and rng.random() < 0.35:
            row = live.pop(rng.randrange(len(live)))
            events.append((*row, -1))
        else:
            row = (rng.choice(KDOM), rng.randrange(vmax))
            if row in live:
                continue
            live.append(row)
            events.append((*row, 1))
    return events


def _times_single(events):
    return [(*e[:-1], 2, e[-1]) for e in events]


def _times_spread(rng: random.Random, events):
    t, out = 2, []
    for e in events:
        if rng.random() < 0.4:
            t += 2
        out.append((*e[:-1], t, e[-1]))
    return out


def _tables(pw, row_lists):
    pw.clear_graph()
    S = pw.schema_from_types(k=str, v=int)
    return [pw.debug.table_from_rows(S, rows, is_stream=True) for rows in row_lists]


def _run_both(build, row_lists, monkeypatch, **flags):
    """{pkg: (final state, update stream)} of ``build`` over ``row_lists``."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        cfg = engine_flags(pkg, monkeypatch, **flags)
        final = final_state(pkg, build(pw, *_tables(pw, row_lists)), config=cfg)
        stream = update_stream(pkg, build(pw, *_tables(pw, row_lists)), config=cfg)
        out[pkg] = (final, stream)
    return out


# ------------------------------------------------ incremental equivalence
def _select_filter(pw, t):
    return t.filter(t.v > 4).select(t.k, w=t.v * 2 + 1)


def _groupby_reduce(pw, t):
    return t.groupby(t.k).reduce(
        t.k, s=pw.reducers.sum(t.v), c=pw.reducers.count(),
        mx=pw.reducers.max(t.v), mn=pw.reducers.min(t.v))


def _global_reduce(pw, t):
    return t.reduce(s=pw.reducers.sum(t.v), n=pw.reducers.count())


def _concat_groupby(pw, t1, t2):
    return (pw.Table.concat_reindex(t1, t2).groupby(pw.this.k)
            .reduce(pw.this.k, s=pw.reducers.sum(pw.this.v)))


def _distinct(pw, t):
    return t.groupby(t.k).reduce(t.k)


CASES = {
    "select_filter": (_select_filter, 1),
    "groupby_reduce": (_groupby_reduce, 1),
    "global_reduce": (_global_reduce, 1),
    "concat_groupby": (_concat_groupby, 2),
    "distinct": (_distinct, 1),
}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", sorted(CASES))
def test_incremental_equals_batch_and_jax(case, seed, monkeypatch):
    """Spread commits end where one commit does, in both packages, with
    JAX's row ids; the spread run's update stream is JAX's, in order."""
    build, n_tables = CASES[case]
    rng = random.Random(seed)
    streams = [_gen_events(rng, 60) for _ in range(n_tables)]
    batch = _run_both(build, [_times_single(ev) for ev in streams], monkeypatch)
    spread = _run_both(build, [_times_spread(rng, ev) for ev in streams], monkeypatch)
    assert spread["torch"][0] == batch["torch"][0] == batch["jax"][0]
    assert spread["torch"][0] == spread["jax"][0]
    assert spread["torch"][1] == spread["jax"][1]
    assert batch["torch"][1] == batch["jax"][1]
    assert spread["torch"][1] and len({e[2] for e in spread["torch"][1]}) > 1


def _threads_build(pw, t1, t2):
    agg = t1.groupby(t1.k).reduce(t1.k, s=pw.reducers.sum(t1.v), n=pw.reducers.count())
    both = pw.Table.concat_reindex(
        t2.select(t2.k, s=t2.v), agg.select(agg.k, s=agg.s * 10 + agg.n))
    return both.groupby(pw.this.k).reduce(pw.this.k, t=pw.reducers.sum(pw.this.s))


@pytest.mark.parametrize("seed", range(3))
def test_threaded_scheduler_equals_single_thread(seed, monkeypatch):
    """threads=3 over spread commits ends where threads=1 over one commit
    does, and equals JAX's run at the same switches."""
    rng = random.Random(seed)
    streams = [_gen_events(rng, 60) for _ in range(2)]
    single = _run_both(_threads_build, [_times_single(ev) for ev in streams],
                       monkeypatch, threads=1)
    threaded = _run_both(_threads_build, [_times_spread(rng, ev) for ev in streams],
                         monkeypatch, threads=3)
    assert threaded["torch"][0] == single["torch"][0] == single["jax"][0]
    assert threaded["torch"][0] == threaded["jax"][0]
    assert threaded["torch"][1] == threaded["jax"][1]


# ------------------------------------------------------------------ fusion
def _chain_select_filter(pw, t):
    s = t.select(t.k, w=t.v * 2 + 1)
    f = s.filter(s.w > 7)
    return f.select(f.k, x=f.w - 3, y=f.k + "!")


def _chain_deep(pw, t):
    s1 = t.select(t.k, a=t.v + 1, b=t.v % 3)
    f1 = s1.filter(s1.b != 0)
    s2 = f1.select(f1.k, c=f1.a * f1.b, b=f1.b)
    f2 = s2.filter(s2.c > 2)
    return f2.select(f2.k, d=f2.c - f2.b)


def _chain_apply(pw, t):
    s = t.select(t.k, w=pw.apply_with_type(lambda v: v * v, int, t.v))
    f = s.filter(s.w < 200)
    return f.select(f.k, z=pw.apply_with_type(str, str, f.w))


def _chain_errors(pw, t):
    s = t.select(t.k, q=100 // (t.v - 3))  # v == 3 rows become ERROR
    f = s.filter(pw.fill_error(s.q > 0, False))
    return f.select(f.k, r=pw.fill_error(f.q * 2, -1))


def _chain_across_groupby(pw, t):
    s = t.select(t.k, w=t.v + 10)
    g = s.groupby(s.k).reduce(s.k, total=pw.reducers.sum(s.w))
    return g.select(g.k, big=g.total * 2)


CHAINS = {"select_filter": _chain_select_filter, "deep": _chain_deep,
          "apply": _chain_apply, "errors": _chain_errors,
          "across_groupby": _chain_across_groupby}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fused_equals_unfused_and_jax(chain, seed, monkeypatch):
    rng = random.Random(seed)
    rows = _times_spread(rng, _gen_events(rng, 50))
    build = CHAINS[chain]
    fused = _run_both(build, [rows], monkeypatch, fusion=True)
    fused_chains = last_run_stats("torch").fused_chains
    unfused = _run_both(build, [rows], monkeypatch, fusion=False)
    assert last_run_stats("torch").fused_chains == 0
    assert fused_chains > 0
    assert fused["torch"] == unfused["torch"]
    assert fused["torch"] == fused["jax"]
    assert unfused["torch"] == unfused["jax"]


def test_fused_chain_reported_in_stats():
    pw = PW["torch"]
    t = _tables(pw, [[("a", 1, 2, 1), ("b", 5, 2, 1)]])[0]
    final_state("torch", _chain_deep(pw, t))
    stats = last_run_stats("torch")
    snap = stats.snapshot()
    assert snap["fused_chains"] >= 1 and snap["fused_nodes"] >= 2
    assert set(stats.engine_tax()) == {
        "wall_s", "steps", "steps_skipped", "operator_dispatches",
        "fused_chains", "fused_nodes"}


# ------------------------------------------------------ streaming semantics
def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _groupby_count(pw):
    t = _md(pw, """
        g | __time__
        a | 2
        a | 4
        """)
    return t.groupby(t.g).reduce(t.g, c=pw.reducers.count())


def _filter_diffs(pw):
    t = _md(pw, """
        v | __time__ | __diff__
        5 | 2        | 1
        5 | 4        | -1
        """)
    return t.filter(t.v > 1)


def _union(pw):
    t1 = _md(pw, """
        v | __time__
        1 | 2
        """)
    t2 = _md(pw, """
        v | __time__
        2 | 4
        """)
    return t1.concat_reindex(t2)


STREAMS = {
    "groupby_count": (_groupby_count, [(2, ("a", 1), True), (4, ("a", 1), False),
                                       (4, ("a", 2), True)]),
    "filter": (_filter_diffs, [(2, (5,), True), (4, (5,), False)]),
    "union": (_union, [(2, (1,), True), (4, (2,), True)]),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_streaming_update_streams(case):
    build, want = STREAMS[case]
    got = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        got[pkg] = update_stream(pkg, build(PW[pkg]))
    assert got["torch"] == got["jax"]
    assert [(t, row, add) for _k, row, t, add in got["torch"]] == want


def test_subscribe_on_time_end_fires_per_epoch():
    got = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = _md(pw, """
            v | __time__
            1 | 2
            2 | 4
            """)
        ends, rows = [], []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: rows.append(time),
                        on_time_end=lambda time: ends.append(time))
        pw.run()
        assert len(ends) >= 2 and set(rows) <= set(ends)
        got[pkg] = (rows, ends)
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------- close-out
def _subscribe_trace(pkg, monkeypatch, columnar: bool, n_rows: int = 12):
    """One python-connector commit of ``n_rows`` rows through subscribe:
    the ordered callback trace, each row with the thread that ran it."""
    pw = PW[pkg]
    pw.clear_graph()
    cfg = engine_flags(pkg, monkeypatch, columnar_subscribe=columnar)

    class S(pw.Schema):
        x: int

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(n_rows):
                self.next(x=i)
            self.commit()
            _t.sleep(0.2)

    t = pw.io.python.read(Src(), schema=S)
    sel = t.select(t.x, y=t.x * 2)
    events, lock = [], threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            events.append(("row", row["x"], row["y"], is_addition,
                           threading.current_thread().name))

    pw.io.subscribe(sel, on_change=on_change,
                    on_time_end=lambda time: events.append(("flush",)),
                    on_end=lambda: events.append(("end",)))

    connectors = list(pw.G.connectors)  # this run's, not a later one's

    def stopper():
        deadline = _t.time() + 20
        while _t.time() < deadline and sum(e[0] == "row" for e in list(events)) < n_rows:
            _t.sleep(0.02)
        for c in connectors:
            c._stop.set()
            c.close()

    threading.Thread(target=stopper, daemon=True).start()
    pw.run(config=cfg) if pkg == "torch" else pw.run()
    return events


@pytest.mark.parametrize("pkg", PACKAGES)
def test_columnar_subscribe_order_parity(pkg, monkeypatch):
    ev_col = _subscribe_trace(pkg, monkeypatch, True)
    ev_inline = _subscribe_trace(pkg, monkeypatch, False)
    rows_col = [e[:4] for e in ev_col if e[0] == "row"]
    assert rows_col == [e[:4] for e in ev_inline if e[0] == "row"]
    assert rows_col == [("row", i, 2 * i, True) for i in range(12)]
    for ev in (ev_col, ev_inline):
        assert ev[-1] == ("end",)
        last_row = max(i for i, e in enumerate(ev) if e[0] == "row")
        assert ("flush",) in ev[last_row + 1:]
    assert all(e[4].startswith("pathway:subscribe:") for e in ev_col if e[0] == "row")
    assert not any(e[4].startswith("pathway:subscribe:") for e in ev_inline
                   if e[0] == "row")


def test_columnar_subscribe_callback_error_propagates():
    pw = PW["torch"]
    pw.clear_graph()

    class S(pw.Schema):
        x: int

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(x=1)
            self.commit()
            _t.sleep(0.3)

    t = pw.io.python.read(Src(), schema=S)

    def boom(key, row, time, is_addition):
        raise RuntimeError("subscriber exploded")

    pw.io.subscribe(t, on_change=boom)

    connectors = list(pw.G.connectors)  # this run's, not a later one's

    def stopper():
        _t.sleep(1.0)
        for c in connectors:
            c._stop.set()
            c.close()

    threading.Thread(target=stopper, daemon=True).start()
    with pytest.raises(RuntimeError, match="subscriber exploded"):
        pw.run()


def _deferred_pipeline(pkg, monkeypatch, n: int = 12, **flags):
    """12 rows through a deferred two-phase UDF at max_batch_size=2 (six
    resolved chunks to drain and coalesce): the live (x, y) rows."""
    pw = PW[pkg]
    pw.clear_graph()
    cfg = engine_flags(pkg, monkeypatch, **flags)

    class Double(pw.UDF):
        def __init__(self):
            super().__init__(deterministic=True, batch=True, max_batch_size=2,
                             executor=pw.udfs.fully_async_executor())

        def __wrapped__(self, xs):
            return [x * 2 for x in xs]

        def submit_batch(self, xs):
            return list(xs)

        def resolve_batch(self, handles):
            _t.sleep(0.01)
            return [[x * 2 for x in h] for h in handles]

    class S(pw.Schema):
        x: int

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(n):
                self.next(x=i)
            self.commit()
            _t.sleep(0.2)

    t = pw.io.python.read(Src(), schema=S)
    sel = t.select(t.x, y=Double()(t.x))
    got, lock = {}, threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            k = (row["x"], row["y"])
            got[k] = got.get(k, 0) + (1 if is_addition else -1)

    pw.io.subscribe(sel, on_change=on_change)

    connectors = list(pw.G.connectors)  # this run's, not a later one's

    def stopper():
        deadline = _t.time() + 30
        while _t.time() < deadline:
            with lock:
                if sum(v != 0 for v in got.values()) == n:
                    break
            _t.sleep(0.02)
        for c in connectors:
            c._stop.set()
            c.close()

    threading.Thread(target=stopper, daemon=True).start()
    pw.run(config=cfg) if pkg == "torch" else pw.run()
    return {k: v for k, v in got.items() if v != 0}


@pytest.mark.parametrize("switch", ["drain_coalesce", "epoch_closeout"])
def test_closeout_switches_preserve_results(switch, monkeypatch):
    expected = {(i, 2 * i): 1 for i in range(12)}
    for pkg in PACKAGES:
        on = _deferred_pipeline(pkg, monkeypatch, **{switch: True})
        off = _deferred_pipeline(pkg, monkeypatch, **{switch: False})
        assert on == off == expected, pkg


def test_consolidate_proof_survives_transforms():
    keys = np.arange(100, 103, dtype=np.int64)
    b = Batch(keys, {"x": np.arange(3, dtype=np.int64)})
    assert not b._consolidated
    assert consolidate(b) is b and b._consolidated
    b2 = b.with_cols({"x": np.arange(3, dtype=np.int64) * 7})
    assert b2._consolidated
    fast = consolidate(b2, closeout=True)
    assert fast is b2
    full = consolidate(b2, closeout=False)
    np.testing.assert_array_equal(full.keys, fast.keys)
    np.testing.assert_array_equal(full.diffs, fast.diffs)
    np.testing.assert_array_equal(full.cols["x"], fast.cols["x"])
    mixed = Batch(keys, {"x": np.arange(3, dtype=np.int64)},
                  diffs=np.array([1, -1, 1], dtype=np.int64))
    consolidate(mixed)
    assert not mixed._consolidated


def test_consolidate_sums_like_jax():
    """Duplicate (key, row) pairs sum, zero groups drop, in the first-
    occurrence order JAX's C++ loop gives."""
    from pathway_tpu.engine.batch import Batch as JBatch
    from pathway_tpu.engine.batch import consolidate as j_consolidate

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 6, 40).astype(np.uint64)
    xs = rng.integers(0, 3, 40)
    diffs = rng.choice([-1, 1], 40).astype(np.int64)
    col = np.empty(40, dtype=object)
    col[:] = [f"v{x}" for x in xs]
    t = consolidate(Batch(keys, {"x": col.copy()}, diffs))
    j = j_consolidate(JBatch(keys, {"x": col.copy()}, diffs))
    for a, b in ((t.keys, j.keys), (t.diffs, j.diffs), (t.cols["x"], j.cols["x"])):
        np.testing.assert_array_equal(a, b)
