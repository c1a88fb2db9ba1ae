"""Deferred (fully-async) two-phase batched UDFs in the port's engine,
held against the blocking path and against the JAX package
(``tests/test_deferred_udf.py``'s cases): the deferred run must give
exactly the blocking run's final table, and JAX's, without parking the
epoch on the drain. Every streaming wait is bounded by a deadline."""

import threading
import time as _t

import pytest

from pathway_tpu_torch.engine.operators import core as t_core
from tests.torch_engine import PACKAGES, PW


def _double_udf(pw, deferred: bool, latency: float = 0.02):
    class Double(pw.UDF):
        def __init__(self):
            super().__init__(deterministic=True, batch=True, max_batch_size=3,
                             executor=pw.udfs.fully_async_executor() if deferred else None)

        def __wrapped__(self, xs):
            return [x * 2 for x in xs]

        def submit_batch(self, xs):
            return list(xs)

        def resolve_batch(self, handles):
            _t.sleep(latency)
            return [[x * 2 for x in h] for h in handles]

    return Double()


def _stop_when(pw, done, lock, seconds=30):
    connectors = list(pw.G.connectors)  # this run's, not a later one's
    def stopper():
        deadline = _t.time() + seconds
        while _t.time() < deadline:
            with lock:
                if done():
                    break
            _t.sleep(0.02)
        for c in connectors:
            c._stop.set()
            c.close()

    threading.Thread(target=stopper, daemon=True).start()


def _run_pipeline(pkg, deferred: bool, with_retract: bool = True):
    pw = PW[pkg]
    pw.clear_graph()
    u = _double_udf(pw, deferred)

    class S(pw.Schema):
        x: int

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(10):
                self.next(x=i)
                if i % 4 == 3:
                    self.commit()
            self.commit()
            if with_retract:
                _t.sleep(0.15)
                self._buffer.append((7777, {"x": 42}, 1))
                self.commit()
                _t.sleep(0.1)
                self._buffer.append((7777, {"x": 42}, -1))
                self.commit()
            _t.sleep(0.2)

    t = pw.io.python.read(Src(), schema=S)
    sel = t.select(t.x, y=u(t.x))
    got, lock = {}, threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            k = (row["x"], row["y"])
            got[k] = got.get(k, 0) + (1 if is_addition else -1)

    pw.io.subscribe(sel, on_change=on_change)

    def done():
        live = {k: v for k, v in got.items() if v != 0}
        return len(live) == 10 and (42, 84) not in live and (
            not with_retract or (42, 84) in got)

    _stop_when(pw, done, lock)
    pw.run()
    return {k: v for k, v in got.items() if v != 0}


def test_deferred_matches_blocking_and_jax(monkeypatch):
    n_deferred = [0]
    orig = t_core.RowwiseNode._step_deferred

    def probe(self, batch):
        n_deferred[0] += 1
        return orig(self, batch)

    monkeypatch.setattr(t_core.RowwiseNode, "_step_deferred", probe)
    blocking = _run_pipeline("torch", deferred=False)
    assert n_deferred[0] == 0, "blocking run must not defer"
    deferred = _run_pipeline("torch", deferred=True)
    assert n_deferred[0] > 0, "deferred run never took the deferred path"
    expected = {(i, i * 2): 1 for i in range(10)}
    assert blocking == deferred == expected
    assert _run_pipeline("jax", deferred=True) == expected


@pytest.mark.parametrize("pkg", PACKAGES)
def test_deferred_mixed_sign_batch_stays_ordered(pkg):
    """A commit that replaces a key (retract old, insert new) is not split
    across injection times: the groupby's state would see the insert while
    the old row still exists."""
    pw = PW[pkg]
    pw.clear_graph()
    u = _double_udf(pw, deferred=True)

    class S(pw.Schema):
        x: int

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            self._buffer.append((4242, {"x": 5}, 1))
            self.commit()
            _t.sleep(0.1)
            self._buffer.append((4242, {"x": 5}, -1))
            self._buffer.append((4242, {"x": 9}, 1))
            self.commit()
            _t.sleep(0.3)

    t = pw.io.python.read(Src(), schema=S)
    sel = t.select(t.x, y=u(t.x))
    agg = sel.groupby().reduce(total=pw.reducers.sum(sel.y))
    got, lock = {}, threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            got[row["total"]] = got.get(row["total"], 0) + (1 if is_addition else -1)

    pw.io.subscribe(agg, on_change=on_change)
    _stop_when(pw, lambda: got.get(18, 0) > 0, lock, seconds=20)
    pw.run()
    assert {k: v for k, v in got.items() if v != 0} == {18: 1}


def test_deferred_static_table_completes():
    """Static tables through a deferred UDF finish the run with every row,
    under JAX's row ids."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        u = _double_udf(pw, deferred=True)
        t = pw.debug.table_from_markdown("""
            x
            1
            2
            3
            """)
        sel = t.select(y=u(t.x))
        out[pkg] = pw.debug.table_to_dicts(sel)[1]["y"]
    assert sorted(out["torch"].values()) == [2, 4, 6]
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_failed_resolve_rows_are_errors(pkg):
    """A resolve that raises turns its rows into ERROR values and logs the
    failure; the run still ends (the in-flight count returns to zero)."""
    pw = PW[pkg]
    pw.clear_graph()
    log = pw.internals.errors.get_global_error_log()
    log.clear()

    class Broken(pw.UDF):
        def __init__(self):
            super().__init__(deterministic=True, batch=True, max_batch_size=2,
                             executor=pw.udfs.fully_async_executor())

        def __wrapped__(self, xs):
            return xs

        def submit_batch(self, xs):
            return list(xs)

        def resolve_batch(self, handles):
            raise ValueError("device lost")

    t = pw.debug.table_from_markdown("""
        x
        1
        2
        3
        """)
    sel = t.select(t.x, y=Broken()(t.x))
    rows = []
    pw.io.subscribe(sel, on_change=lambda key, row, time, is_addition: rows.append(row),
                    skip_errors=False)
    pw.run(terminate_on_error=False)
    assert sorted(r["x"] for r in rows) == [1, 2, 3]
    assert all(r["y"] is pw.ERROR for r in rows)
    assert any("device lost" in e["message"] for e in log.entries)
