"""Ordered-table operations (reference ``stdlib/ordered/diff.py``)."""

from __future__ import annotations

from pathway_tpu_torch.internals import expression as expr_mod


def diff(table, timestamp, *values, instance=None):
    """Per-row difference with the previous row ordered by ``timestamp``:
    ``diff_<name>`` columns (reference ``Table.diff``)."""
    sorted_ptrs = table.sort(timestamp, instance=instance)
    prev_vals = {}
    for v in values:
        name = v.name if isinstance(v, expr_mod.ColumnReference) else str(v)
        prev = table.ix(sorted_ptrs.prev, optional=True)[name]
        prev_vals[f"diff_{name}"] = expr_mod.apply_with_type(
            lambda cur, pv: None if pv is None else cur - pv,
            None,
            table[name],
            prev,
        )
    return table.with_columns(**prev_vals)
