"""Statistical helpers (reference ``stdlib/statistical/_interpolate.py``)."""

from __future__ import annotations

import enum

from pathway_tpu_torch.internals import expression as expr_mod


class InterpolateMode(enum.Enum):
    LINEAR = 0


def interpolate(table, timestamp, *values, mode: InterpolateMode | None = None):
    """Linear interpolation of None values between neighbors ordered by
    ``timestamp`` (reference ``Table.interpolate``). Current implementation
    fills from the previous non-None neighbor pair via prev/next pointers."""
    mode = mode or InterpolateMode.LINEAR
    sorted_ptrs = table.sort(timestamp)
    with_ptrs = table.with_columns(
        __prev=sorted_ptrs.prev, __next=sorted_ptrs.next
    )
    out = {}
    ts_name = timestamp.name

    for v in values:
        name = v.name if isinstance(v, expr_mod.ColumnReference) else str(v)

        prev_val = table.ix(with_ptrs["__prev"], optional=True)[name]
        next_val = table.ix(with_ptrs["__next"], optional=True)[name]
        prev_ts = table.ix(with_ptrs["__prev"], optional=True)[ts_name]
        next_ts = table.ix(with_ptrs["__next"], optional=True)[ts_name]

        def interp(cur, pv, nv, pt, nt, ct):
            if cur is not None:
                return float(cur)
            if pv is None and nv is None:
                return None
            if pv is None:
                return float(nv)
            if nv is None:
                return float(pv)
            if nt == pt:
                return float(pv)
            frac = (ct - pt) / (nt - pt)
            return float(pv) + (float(nv) - float(pv)) * frac

        out[name] = expr_mod.apply_with_type(
            interp,
            float | None,
            table[name],
            prev_val,
            next_val,
            prev_ts,
            next_ts,
            table[ts_name],
        )
    return table.with_columns(**out)
