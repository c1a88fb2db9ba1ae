"""Table display: live widget when panel/bokeh are installed, static HTML
snapshot otherwise (counterpart of ``pathway_tpu/stdlib/viz/table_viz.py``).

Mirrors the reference's jupyter integration (`stdlib/viz/table_viz.py:26`
``show`` + ``_repr_mimebundle_``) with an explicit no-dependency fallback:
headless GPU hosts usually lack panel, so ``show`` must degrade to
something useful instead of ImportError-ing the whole notebook cell.

Tensor cells (an embedding column on the card) are shown with their values.
Reading a CUDA tensor's values one cell at a time would synchronise the
device once per cell, so :func:`host_columns` first copies each column's
device-resident tensors to the host in one transfer (one per column and
dtype) and :func:`_format_value` formats the host copies; a CUDA tensor
that reaches ``_format_value`` on its own is shown by shape, dtype and
device, without its values and without a sync.
"""

from __future__ import annotations

from typing import Any

import torch


def _dtype_label(dtype: Any) -> str:
    s = str(dtype)
    return s.removeprefix("<class '").removesuffix("'>")


def _snapshot_dataframe(table):
    from pathway_tpu_torch.debug import table_to_pandas

    return table_to_pandas(table)


def _frame_for_display(df, include_id: bool, short_pointers: bool):
    if not include_id:
        return df.reset_index(drop=True)
    if short_pointers:
        df = df.copy()
        df.index = [str(i)[:12] for i in df.index]
    return df


class _HostTensor:
    """A device tensor's values, copied to the host by :func:`host_columns`,
    shown as ``repr`` shows the device tensor."""

    __slots__ = ("host", "device")

    def __init__(self, host: torch.Tensor, device: torch.device):
        self.host = host
        self.device = device

    def __repr__(self) -> str:
        return repr(self.host)[:-1] + f", device='{self.device}')"

    __str__ = __repr__


def host_columns(columns: dict) -> dict:
    """``{column: [cell, ...]}`` with every tensor cell that is not on the
    CPU replaced by a :class:`_HostTensor`. A column's device tensors are
    flattened and concatenated on their device, copied in ONE transfer
    (per device and dtype), and split back on the host: at most one copy
    per column per snapshot, not one device sync per cell."""
    out = {}
    for name, cells in columns.items():
        groups: dict[tuple, list[int]] = {}
        for i, v in enumerate(cells):
            if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                groups.setdefault((v.device, v.dtype), []).append(i)
        if not groups:
            out[name] = cells
            continue
        cells = list(cells)
        for (device, _dtype), idx in groups.items():
            parts = [cells[i] for i in idx]
            flat = torch.cat([p.detach().reshape(-1) for p in parts]).cpu()
            off = 0
            for i, p in zip(idx, parts):
                n = p.numel()
                cells[i] = _HostTensor(flat[off:off + n].reshape(p.shape), device)
                off += n
        out[name] = cells
    return out


def _host_frame(df):
    """``df`` with its device tensor cells copied by :func:`host_columns`."""
    cols = host_columns({c: list(df[c]) for c in df.columns})
    df = df.copy()
    for c, cells in cols.items():
        df[c] = cells
    return df


def _format_value(x, short_pointers: bool = True):
    """Type-aware cell formatting (reference ``table_viz.py:60-70``
    ``_format_types``): Pointers shorten, long Json truncates, tensors show
    their values (host copies) or, on a device, their shape, dtype and
    device; the rest passes through."""
    from pathway_tpu_torch.engine.value import Pointer
    from pathway_tpu_torch.internals.json import Json

    if isinstance(x, _HostTensor):
        return repr(x)
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            return repr(x)
        # reading the values would synchronise the device for this cell
        return (f"tensor(shape={tuple(x.shape)}, dtype={x.dtype}, "
                f"device='{x.device}')")

    if isinstance(x, Pointer):
        s = str(x)
        if len(s) > 8 and short_pointers:
            s = s[:8] + "..."
        return s
    if isinstance(x, Json):
        s = str(x)
        if len(s) > 64:
            s = s[:64] + " ..."
        return s
    return x


def show(
    table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    snapshot: bool = True,
):
    """Display a table. With panel installed, returns a live-updating panel
    widget fed by ``io.subscribe``; without it, computes the current static
    snapshot and returns an HTML object (works in plain Jupyter).

    ``snapshot=False`` shows the CHANGELOG instead of the current state:
    every update row with its engine ``time`` and ``diff``, newest first,
    retractions styled red / additions green — the reference's streaming
    table view (stdlib/viz/table_viz.py:55-100).
    """
    try:
        import panel as pn
    except ImportError:
        pn = None

    if pn is None:
        df = _frame_for_display(
            _snapshot_dataframe(table), include_id, short_pointers
        )
        df = _host_frame(df).map(lambda x: _format_value(x, short_pointers))
        html = df.to_html(max_rows=100)
        try:  # inside IPython, return a rich display object
            from IPython.display import HTML

            return HTML(html)
        except ImportError:
            return html

    import pandas as pd

    import pathway_tpu_torch as pw

    column_names = list(table.schema.column_names())
    frame_cols = column_names + (["time", "diff"] if not snapshot else [])
    widget = pn.widgets.Tabulator(
        pd.DataFrame(columns=frame_cols), disabled=True
    )
    if not snapshot:
        # changelog view: color retractions red, additions green
        def _diff_colors(row):
            color = "red" if row["diff"] < 0 else "green"
            return [f"color: {color}" for _ in row]

        style = getattr(widget, "style", None)
        if style is not None:
            style.apply(_diff_colors, axis=1)

    rows: dict[Any, dict] = {}
    changelog: list[dict] = []

    def on_change(key, row, time, is_addition):
        if snapshot:
            if is_addition:
                rows[key] = row
            else:
                rows.pop(key, None)
        else:
            changelog.append(
                {**row, "time": time, "diff": 1 if is_addition else -1}
            )

    def on_time_end(time):
        if snapshot:
            df = _frame_for_display(
                pd.DataFrame.from_dict(rows, orient="index"),
                include_id, short_pointers,
            )
        else:
            df = pd.DataFrame(
                list(reversed(changelog)), columns=frame_cols
            )
        widget.value = _host_frame(df).map(
            lambda x: _format_value(x, short_pointers))

    pw.io.subscribe(table, on_change=on_change, on_time_end=on_time_end)
    return pn.Column(widget)


def _repr_mimebundle_(self, include=None, exclude=None):
    """Rich notebook repr: schema summary without forcing a compute."""
    cols = {
        name: _dtype_label(cdef.dtype)
        for name, cdef in self.schema.columns().items()
    }
    head = "".join(
        f"<tr><td>{n}</td><td><tt>{t}</tt></td></tr>" for n, t in cols.items()
    )
    html = (
        "<table><thead><tr><th>column</th><th>dtype</th></tr></thead>"
        f"<tbody>{head}</tbody></table>"
    )
    return {"text/html": html, "text/plain": repr(self)}
