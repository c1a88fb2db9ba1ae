"""``LiveTable``, interactive mode and ``stdlib.stateful`` in the port,
held against the JAX package: ``tests/test_misc_final_matrix.py:156`` and
``:202`` (a static live table; a streaming one that follows new files
without a re-run), ``tests/test_api_surface_parity.py:392`` (the
controller) and ``tests/test_multiworker_rerun.py:257`` (``deduplicate``),
each on both packages with equal row ids and values. Then the port's own
case: a live table over a tensor column whose rows are updated, where a
retraction arrives as a distinct tensor object of equal bytes. JAX's
``==`` on those rows raises (pinned); the port compares them by bytes and
shows the updated rows only. Every wait is bounded."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from tests.torch_engine import PACKAGES, PW, canon

pytestmark = pytest.mark.timeout(120)

WAIT = 20.0


@pytest.fixture(autouse=True)
def _clean():
    yield
    for pw in PW.values():
        pw.clear_graph()


def _frame(df):
    return sorted((int(k.value), tuple(canon(v) for v in row))
                  for k, row in zip(df.index, df.itertuples(index=False)))


def test_live_table_snapshot():
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        lt = pw.LiveTable(pw.debug.table_from_markdown("""
            a
            1
            2
            """))
        assert lt.wait(WAIT) and lt.done() and not lt.failed()
        out[pkg] = _frame(lt.snapshot())
    assert out["torch"] == out["jax"]
    assert sorted(r for _k, r in out["torch"]) == [(1,), (2,)]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_live_table_streams_updates_without_rerun(pkg, tmp_path):
    pw = PW[pkg]
    src = tmp_path / "live"
    src.mkdir()
    (src / "a.jsonl").write_text(json.dumps({"w": "x", "n": 1}) + "\n")

    class S(pw.Schema):
        w: str
        n: int

    pw.clear_graph()
    t = pw.io.jsonlines.read(str(src), schema=S, mode="streaming", refresh_interval=0.02)
    lt = pw.LiveTable(t.groupby(t.w).reduce(t.w, total=pw.reducers.sum(t.n)))
    try:
        deadline = time.time() + WAIT
        while time.time() < deadline and len(lt.snapshot()) < 1:
            time.sleep(0.02)
        assert lt.snapshot()["total"].tolist() == [1]
        first = lt.frontier
        (src / "b.jsonl").write_text(json.dumps({"w": "x", "n": 10}) + "\n"
                                     + json.dumps({"w": "y", "n": 5}) + "\n")
        while time.time() < deadline and lt.snapshot()["total"].sum() != 16:
            time.sleep(0.02)
        df = lt.snapshot()
        assert sorted(zip(df["w"], df["total"])) == [("x", 11), ("y", 5)]
        assert lt.frontier > first and not lt.failed() and not lt.done()
    finally:
        lt.stop()
    assert lt.done()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_enable_interactive_mode_controller(pkg):
    pw = PW[pkg]
    pw.clear_graph()
    with pytest.warns(UserWarning, match="experimental"):
        ctl = pw.enable_interactive_mode()
    try:
        assert ctl.enabled
        lt = pw.debug.table_from_markdown("""
            v | __time__
            1 | 2
            """).live()
        assert lt in ctl._live and isinstance(lt, pw.LiveTable)
    finally:
        ctl.stop()
    assert not ctl.enabled and lt.wait(WAIT)


def test_stateful_deduplicate():
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.debug.table_from_markdown("""
            v | __time__
            1 | 2
            3 | 4
            2 | 6
            """)
        res = pw.stateful.deduplicate(t, value=t.v, acceptor=lambda new, old: new > old)
        out[pkg] = pw.debug.table_to_dicts(res)
        out[pkg] = sorted((int(k), v) for k, v in out[pkg][1]["v"].items())
    assert out["torch"] == out["jax"]
    assert [v for _k, v in out["torch"]] == [3]


def _tensor_updates(pw, array):
    """Three rows with a vector column, then rows 0 and 1 updated: the
    retraction carries a fresh array or tensor of the old row's bytes."""
    from importlib import import_module

    core = import_module(f"{pw.__name__}.engine.operators.core")
    streams = import_module(f"{pw.__name__}.io._streams")
    table_mod = import_module(f"{pw.__name__}.internals.table")
    universe = import_module(f"{pw.__name__}.internals.universe")
    node = core.InputNode(pw.G.engine_graph, ["doc", "vec"], name="vecs")
    rows = [(k, (k, array([float(k)] * 3)), 2, 1) for k in range(3)]
    for k in (0, 1):
        rows.append((k, (k, array([float(k)] * 3)), 4, -1))
        rows.append((k, (k, array([k + 0.5] * 3)), 4, 1))
    conn = streams.StaticStreamConnector(node, rows, ["doc", "vec"])
    pw.G.register_connector(conn)
    return table_mod.Table(node, pw.schema_from_types(doc=int, vec=object),
                           universe.Universe())


def test_live_table_over_an_updated_tensor_column():
    """The port removes a retracted row whose tensor equals the visible one
    by bytes; JAX's ``==`` of the two rows raises on the same stream of
    ndarrays (its background run fails)."""
    import pathway_tpu as JPW
    import pathway_tpu_torch as TPW

    TPW.clear_graph()
    lt = TPW.LiveTable(_tensor_updates(TPW, torch.tensor))
    assert lt.wait(WAIT) and not lt.failed()
    df = lt.snapshot()
    assert sorted((d, v.tolist()) for d, v in zip(df["doc"], df["vec"])) == [
        (0, [0.5] * 3), (1, [1.5] * 3), (2, [2.0] * 3)]
    TPW.clear_graph()
    lt = TPW.LiveTable(_tensor_updates(TPW, np.array))
    assert lt.wait(WAIT) and not lt.failed()
    assert sorted(lt.snapshot()["doc"].tolist()) == [0, 1, 2]
    JPW.clear_graph()
    jlt = JPW.LiveTable(_tensor_updates(JPW, np.array))
    assert jlt.wait(WAIT) and jlt.failed()
    assert "truth value of an array" in str(jlt.exception)
