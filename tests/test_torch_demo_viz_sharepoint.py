"""``pw.demo``, ``pw.viz`` (``Table.show`` / ``Table.plot``) and the
SharePoint reader of the port against the JAX package's (the bars:
``tests/test_api_breadth.py:151``, ``tests/test_io.py:152``,
``tests/test_io_formats.py:215``, ``tests/test_debug_monitor_matrix.py:
255-340`` with bokeh and panel stubbed as there, and
``tests/test_io_backends.py:267``).

The demo generators' captured rows (row ids and values) and update
streams must equal JAX's; the viz stubs record what each package pushes to
its figure or widget; a CPU tensor cell is shown with its values, and a
device tensor column reaches the host in one copy."""

import json
import random
import sys
import threading
import time
import types

import pytest
import torch

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu_torch.stdlib.viz import table_viz
from tests.torch_engine import PACKAGES, PW, canon, final_state

WAIT = 20.0


@pytest.fixture(autouse=True)
def _clean():
    for pw in PW.values():
        pw.clear_graph()
    yield
    for pw in PW.values():
        pw.clear_graph()


def _both_final(build):
    out = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        out[pkg] = final_state(pkg, build(PW[pkg]))
    assert out["torch"] == out["jax"]
    return out["torch"]


def _both_stream(build):
    """Every subscribe event of one run of ``build(pw)``'s table, per
    package, as ``(row id, row, is_addition)`` in order."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        events = []
        pw.io.subscribe(build(pw), on_change=lambda key, row, time, is_addition, ev=events:
                        ev.append((key.value, tuple(canon(v) for v in row.values()),
                                   is_addition)))
        pw.run()
        out[pkg] = events
    assert out["torch"] == out["jax"]
    return out["torch"]


# ------------------------------------------------------------------- demo


def test_demo_range_stream_rows_and_stream_equal_jax():
    rows, cols = _both_final(lambda pw: pw.demo.range_stream(nb_rows=5, offset=3,
                                                             input_rate=0))
    assert cols == ["value"] and sorted(r[0] for r in rows.values()) == [3, 4, 5, 6, 7]
    events = _both_stream(lambda pw: pw.demo.range_stream(nb_rows=5, input_rate=0))
    assert [e[1] for e in events] == [(i,) for i in range(5)]


def test_demo_range_stream_reduced_sum():
    """``tests/test_io.py``'s case: the running sum ends at 10."""
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.demo.range_stream(nb_rows=5, input_rate=0)
        total = t.reduce(s=pw.reducers.sum(t.value))
        seen = []
        pw.io.subscribe(total, on_change=lambda key, row, time, is_addition:
                        seen.append((row["s"], is_addition)))
        pw.run()
        assert (10, True) in seen[-2:], (pkg, seen)


def test_demo_paced_stream_stopped_from_outside():
    """``tests/test_api_breadth.py``'s and ``tests/test_io_formats.py``'s
    cases: a paced stream with a stopper; every row arrives, bounded."""
    pw = TPW
    t = pw.demo.range_stream(nb_rows=5, input_rate=100.0, autocommit_duration_ms=10)
    seen = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row))
    conns = list(pw.G.connectors)

    def stop():
        deadline = time.time() + WAIT
        while time.time() < deadline and len(seen) < 5:
            time.sleep(0.02)
        for c in conns:
            c._stop.set()
            c.close()

    th = threading.Thread(target=stop, daemon=True)
    th.start()
    t0 = time.perf_counter()
    pw.run()
    th.join(WAIT)
    assert [r["value"] for r in seen] == [0, 1, 2, 3, 4]
    assert time.perf_counter() - t0 >= 4 / 100.0  # paced at input_rate


def test_demo_custom_stream_with_primary_key_equals_jax():
    def build(pw):
        class S(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            name: str
            x: float

        return pw.demo.generate_custom_stream(
            {"k": lambda i: 10 * i, "name": lambda i: f"n{i}", "x": lambda i: i / 4},
            schema=S, nb_rows=7, input_rate=0)

    rows, _ = _both_final(build)  # row ids from the primary key, as JAX's
    assert sorted(rows.values()) == [(10 * i, f"n{i}", i / 4) for i in range(7)]
    _both_stream(build)


def test_demo_noisy_linear_stream_equals_jax():
    def build(pw):
        random.seed(1234)
        return pw.demo.noisy_linear_stream(nb_rows=6, input_rate=0)

    rows, cols = _both_final(build)
    assert cols == ["x", "y"]
    for x, y in rows.values():
        assert abs(y - x) <= 1.0


@pytest.mark.parametrize("with_time", [False, True])
def test_demo_replay_csv_equals_jax(tmp_path, with_time):
    path = tmp_path / "docs.csv"
    path.write_text("doc,n,score,flag,t\n" + "".join(
        f"text {i},{i},{i / 8},{'true' if i % 2 else 'false'},{i * 10}\n"
        for i in range(20)))

    def build(pw):
        class S(pw.Schema):
            doc: str
            n: int
            score: float
            flag: bool
            t: int

        if with_time:
            return pw.demo.replay_csv_with_time(str(path), schema=S, time_column="t",
                                                unit="ms")
        return pw.demo.replay_csv(str(path), schema=S, input_rate=0)

    rows, _ = _both_final(build)
    assert sorted(rows.values(), key=lambda r: r[1]) == [
        (f"text {i}", i, i / 8, bool(i % 2), i * 10) for i in range(20)]
    events = _both_stream(build)
    assert [e[1][1] for e in events] == list(range(20))  # file order, one commit a row


# --------------------------------------------------------------- viz stubs


class _StubSource:
    def __init__(self, data=None):
        self.data = data or {}
        self.streamed: list = []

    def stream(self, data, rollover=None):
        self.streamed.append((data, rollover))
        self.data = data


def _install_viz_stubs(monkeypatch):
    bokeh = types.ModuleType("bokeh")
    models = types.ModuleType("bokeh.models")
    models.ColumnDataSource = _StubSource
    bokeh.models = models

    class _Box:
        def __init__(self, *children, **kw):
            self.children = list(children)

    class _Tabulator:
        def __init__(self, value, **kw):
            self.value = value
            self.style = None

    panel = types.ModuleType("panel")
    panel.Column = _Box
    panel.Row = _Box
    widgets = types.ModuleType("panel.widgets")
    widgets.Tabulator = _Tabulator
    panel.widgets = widgets
    monkeypatch.setitem(sys.modules, "bokeh", bokeh)
    monkeypatch.setitem(sys.modules, "bokeh.models", models)
    monkeypatch.setitem(sys.modules, "panel", panel)
    monkeypatch.setitem(sys.modules, "panel.widgets", widgets)


def test_table_show_and_plot_are_attached():
    assert TPW.Table.show is table_viz.show
    assert TPW.Table.plot is TPW.viz.plot
    assert "_repr_mimebundle_" in vars(TPW.Table)


def test_plot_needs_bokeh_and_panel(monkeypatch):
    monkeypatch.setitem(sys.modules, "panel", None)
    t = TPW.debug.table_from_markdown("a\n1")
    with pytest.raises(ImportError, match="bokeh and panel"):
        t.plot(lambda source: "FIG")


def test_plot_bounded_renders_immediately(monkeypatch):
    _install_viz_stubs(monkeypatch)
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        t = pw.debug.table_from_markdown(
            """
            a | b
            3 | 30
            1 | 10
            2 | 20
            """
        )
        captured = {}

        def fig_fn(source, captured=captured):
            captured["source"] = source
            return "FIG"

        viz = t.plot(fig_fn, sorting_col="a")
        assert viz.children[0].children == ["Static preview"]
        out[pkg] = captured["source"].streamed
    assert out["torch"] == out["jax"]
    ((data, rollover),) = out["torch"]
    assert data["a"] == [1, 2, 3] and data["b"] == [10, 20, 30] and rollover == 3


def test_plot_streaming_updates_on_time_end(monkeypatch):
    _install_viz_stubs(monkeypatch)
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        broker = pw.io.kafka.InMemoryKafkaBroker()
        for i in range(3):
            broker.produce("t", json.dumps({"a": i}).encode())
        broker.close()

        class S(pw.Schema):
            a: int

        t = pw.io.kafka.read(broker, topic="t", schema=S)
        captured = {}

        def fig_fn(source, captured=captured):
            captured["source"] = source
            return "FIG"

        viz = t.plot(fig_fn, sorting_col="a")
        assert viz.children[0].children == ["Streaming mode"]
        assert captured["source"].streamed == []
        pw.run()
        out[pkg] = captured["source"].streamed[-1]
    assert out["torch"] == out["jax"]
    data, rollover = out["torch"]
    assert data["a"] == [0, 1, 2] and rollover == 3


def test_show_changelog_mode(monkeypatch):
    _install_viz_stubs(monkeypatch)
    pw = TPW

    class S(pw.Schema):
        w: str = pw.column_definition(primary_key=True)
        n: int

    broker = pw.io.kafka.InMemoryKafkaBroker()
    broker.produce("t", json.dumps({"w": "x", "n": 1}).encode())
    t = pw.io.kafka.read(broker, topic="t", schema=S)
    (conn,) = pw.G.connectors

    def feed_upsert():
        # the upsert in a later read than the insert, or one commit holds
        # both and consolidation collapses them
        deadline = time.time() + WAIT
        while time.time() < deadline and conn._offset < 1:
            time.sleep(0.02)
        broker.produce("t", json.dumps({"w": "x", "n": 2}).encode())
        broker.close()

    viz = t.show(snapshot=False)
    th = threading.Thread(target=feed_upsert, daemon=True)
    th.start()
    pw.run()
    th.join(WAIT)
    df = viz.children[0].value
    assert list(df.columns) == ["w", "n", "time", "diff"]
    assert list(df["diff"]) in ([1, -1, 1], [-1, 1, 1])
    assert set(df["n"]) == {1, 2}


def test_show_snapshot_fallback_with_a_cpu_tensor_cell(monkeypatch):
    """Without panel, show() renders the snapshot as HTML; a CPU tensor
    cell shows its values, as ``repr`` shows them."""
    monkeypatch.setitem(sys.modules, "panel", None)
    monkeypatch.setitem(sys.modules, "IPython.display", None)
    pw = TPW
    t = pw.debug.table_from_markdown(
        """
        a | s
        1 | x
        2 | y
        """
    )
    t = t.select(t.a, t.s, v=pw.apply(lambda a: torch.tensor([a / 2, -1.0]), t.a))
    html = t.show(include_id=False)
    assert isinstance(html, str) and "<table" in html
    assert "tensor([ 0.5000, -1.0000])" in html and "tensor([ 1., -1.])" in html
    jt = JPW.debug.table_from_markdown("a | s\n1 | x\n2 | y")
    jhtml = jt.show(include_id=False)
    for cell in ("<td>x</td>", "<td>y</td>", "<th>a</th>", "<th>s</th>"):
        assert cell in html and cell in jhtml


def test_device_tensor_columns_reach_the_host_in_one_copy(monkeypatch):
    """Tensors off the CPU (the ``meta`` device stands in for CUDA here):
    each column's cells are concatenated on their device and copied once,
    and ``_format_value`` shows a device tensor without reading it."""
    copies = []

    def fake_cpu(self):
        copies.append(tuple(self.shape))
        return torch.arange(self.numel(), dtype=self.dtype).reshape(self.shape)

    monkeypatch.setattr(torch.Tensor, "cpu", fake_cpu)
    cells_a = [torch.empty(2, device="meta"), torch.empty(3, device="meta"),
               torch.empty((1, 2), device="meta")]
    cells_b = [torch.empty(4, device="meta", dtype=torch.int32), "text", None]
    cols = table_viz.host_columns({"a": cells_a, "b": cells_b,
                                   "c": [1, 2, torch.tensor([1.0])]})
    assert copies == [(7,), (4,)]  # one copy a column
    assert repr(cols["a"][1]) == "tensor([2., 3., 4.], device='meta')"
    assert repr(cols["a"][2]) == "tensor([[5., 6.]], device='meta')"
    assert cols["b"][1:] == ["text", None] and cols["c"][2] is not None
    assert "dtype=torch.int32" in repr(cols["b"][0])
    formatted = table_viz._format_value(torch.empty((2, 3), device="meta"))
    assert formatted == "tensor(shape=(2, 3), dtype=torch.float32, device='meta')"
    assert table_viz._format_value(cols["a"][0]) == "tensor([0., 1.], device='meta')"
    assert len(copies) == 2


def test_format_value_pointers_and_json_equal_jax():
    from pathway_tpu.stdlib.viz.table_viz import _format_value as j_format

    long_json = {"k": "v" * 100}
    assert table_viz._format_value(TPW.Json(long_json)) == j_format(JPW.Json(long_json))
    assert table_viz._format_value(TPW.Pointer(123456789123)) == j_format(
        JPW.Pointer(123456789123))
    assert table_viz._format_value(5) == j_format(5) == 5


# ------------------------------------------------------------- SharePoint


class FakeSharePoint:
    def __init__(self, files=None):
        self.files = files or {"/sites/docs/a.pdf": (b"pdf", "2026-01-01")}
        self.downloads = []

    def list_files(self, root_path, recursive):
        return [{"path": p, "name": p.rsplit("/", 1)[1], "modified_at": m,
                 "size": len(d), "base_url": "https://sp.example"}
                for p, (d, m) in sorted(self.files.items())]

    def download(self, path):
        self.downloads.append(path)
        return self.files[path][0]


def _sharepoint(pw):
    from importlib import import_module

    pkg = "pathway_tpu" if pw is JPW else "pathway_tpu_torch"
    return import_module(f"{pkg}.xpacks.connectors.sharepoint")


def test_sharepoint_read_static_equals_jax():
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = _sharepoint(pw).read(root_path="/sites/docs", mode="static",
                                 with_metadata=True, _client=FakeSharePoint())
        rows, cols = final_state(pkg, t)
        ((rid, row),) = rows.items()
        out[pkg] = (rid, row[cols.index("data")])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == b"pdf"
    TPW.clear_graph()
    t = _sharepoint(TPW).read(root_path="/sites/docs", mode="static", with_metadata=True,
                              _client=FakeSharePoint())
    df = TPW.debug.table_to_pandas(t)
    meta = df["_metadata"].iloc[0].value
    assert meta["name"] == "a.pdf" and meta["status"] == "downloaded"
    assert meta["url"] == "https://sp.example/sites/docs/a.pdf"


def test_sharepoint_size_limit_and_no_metadata_equal_jax():
    files = {"/s/small.txt": (b"ok", "1"), "/s/big.bin": (b"x" * 100, "1")}
    rows, cols = _both_final(lambda pw: _sharepoint(pw).read(
        root_path="/s", mode="static", object_size_limit=10,
        _client=FakeSharePoint(files)))
    assert cols == ["data"] and [r[0] for r in rows.values()] == [b"ok"]


def test_sharepoint_missing_sdk_raises_jax_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "office365", None)
    monkeypatch.setitem(sys.modules, "office365.sharepoint", None)
    monkeypatch.setitem(sys.modules, "office365.sharepoint.client_context", None)
    msgs = []
    for pkg in PACKAGES:
        with pytest.raises(ImportError) as info:
            _sharepoint(PW[pkg]).read(url="https://sp.example", root_path="/s")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "office365-rest-python-client" in msgs[1]


def test_sharepoint_streaming_modification_and_persistent_id():
    """A streaming read picks up a modified file (retract, then the new
    bytes), and ``persistent_id`` registers the connector as JAX's does."""
    from pathway_tpu_torch import persistence

    pw = TPW
    client = FakeSharePoint({"/s/a.txt": (b"v1", "1"), "/s/b.txt": (b"b", "1")})
    t = _sharepoint(pw).read(root_path="/s", mode="streaming", refresh_interval=0.05,
                             _client=client, persistent_id="sp-source")
    (conn,) = pw.G.connectors
    assert persistence.get_persistent_sources()["sp-source"] is conn
    assert conn.persistent_id == "sp-source"
    events = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    events.append((row["data"], is_addition)))

    def feed():
        deadline = time.time() + WAIT
        while time.time() < deadline and len(events) < 2:
            time.sleep(0.02)
        client.files["/s/a.txt"] = (b"v2", "2")
        while time.time() < deadline and len(events) < 4:
            time.sleep(0.02)
        conn._stop.set()
        conn.close()

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    pw.run()
    th.join(WAIT)
    assert sorted(events[:2]) == [(b"b", True), (b"v1", True)]
    assert sorted(events[2:]) == [(b"v1", False), (b"v2", True)]
