"""Live Bokeh plots over streaming tables (counterpart of
``pathway_tpu/stdlib/viz/plotting.py``).

Reference parity: ``stdlib/viz/plotting.py:35`` ``plot(table,
plotting_function, sorting_col)`` — a user function receives a Bokeh
``ColumnDataSource`` and returns a figure. Like the reference:

* a table with only BOUNDED inputs renders immediately ("Static preview"
  banner) — the subgraph is computed on the spot and the source filled;
* a table with streaming inputs renders a "Streaming mode" banner and the
  source auto-updates from the change stream after ``pw.run()`` starts,
  via incremental ``source.stream(..., rollover=n)`` pushes (not full
  re-assignment — bokeh diffs streamed patches efficiently).

Bokeh/panel are optional: on headless hosts ``plot`` raises a clear
ImportError naming the extras instead of failing at some deeper import.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.stdlib.viz.table_viz import host_columns


def _has_streaming_input(table) -> bool:
    """True when any live connector feeds the table's subgraph (the
    reference asks its GraphRunner ``has_bounded_input``; here sources are
    explicit on the parse graph: connectors stream, static sources don't).
    """
    from pathway_tpu_torch.internals.parse_graph import G

    seen: set[int] = set()
    stack = [table._node]
    connector_nodes = {c.node.id for c in G.connectors}
    while stack:
        node = stack.pop()
        if node.id in seen:
            continue
        seen.add(node.id)
        if node.id in connector_nodes:
            return True
        stack.extend(node.inputs)
    return False


def _ordered_rows(rows: dict, column_names, sorting_col):
    ordered = list(rows.values())
    if sorting_col is not None:
        name = getattr(sorting_col, "name", sorting_col)
        ordered.sort(key=lambda r: r[name])
    return {c: [r.get(c) for r in ordered] for c in column_names}


def plot(table, plotting_function: Callable, sorting_col=None):
    """Build a live plot of the table.

    ``plotting_function(source) -> bokeh.models.Plot`` receives a
    ``ColumnDataSource`` whose columns follow the table's columns; the
    returned figure re-renders on every engine time advancement (or at
    once for bounded inputs).
    """
    try:
        import panel as pn
        from bokeh.models import ColumnDataSource
    except ImportError as e:
        raise ImportError(
            "pw.Table.plot needs the optional viz dependencies; "
            "install bokeh and panel"
        ) from e

    import pathway_tpu_torch as pw

    column_names = table.schema.column_names()
    source = ColumnDataSource(data={c: [] for c in column_names})
    fig = plotting_function(source)
    streaming = _has_streaming_input(table)
    banner = "Streaming mode" if streaming else "Static preview"
    viz = pn.Column(pn.Row(banner), fig)

    if not streaming:
        # bounded inputs: compute the snapshot right away, like the
        # reference's immediate preview for bounded data sources
        from pathway_tpu_torch.internals.run import capture_table

        cap = capture_table(table)
        rows = {
            k: dict(zip(cap.column_names, row))
            for k, row in dict(cap.state.rows).items()
        }
        data = host_columns(_ordered_rows(rows, column_names, sorting_col))
        n = len(next(iter(data.values()), []))
        source.stream(data, rollover=n or None)
        return viz

    rows: dict[Any, dict] = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            rows[key] = row
        else:
            rows.pop(key, None)

    def on_time_end(time):
        data = host_columns(_ordered_rows(rows, column_names, sorting_col))
        if not rows:
            # an all-rows retraction must CLEAR the figure; stream() with
            # empty columns would leave the stale points rendered
            source.data = data
            return
        # stream+rollover replaces the window in one patch; bokeh ships
        # the patch to the browser instead of re-serializing the figure
        source.stream(data, rollover=len(rows))

    pw.io.subscribe(table, on_change=on_change, on_time_end=on_time_end)
    return viz
