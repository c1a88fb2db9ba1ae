"""Gradual broadcast — attach an approximate value to every row, updating
rows lazily.

Reference ``src/engine/dataflow/operators/gradual_broadcast.rs:65``: a
threshold stream carries (lower, value, upper); every row of the main input
gets an ``apx_value``. A row KEEPS the value it was emitted with as long as
that value stays inside the current [lower, upper] band — only rows whose
assigned value falls outside the band are retracted and re-emitted. The LSH
bucketer's apx updates move the band slightly on most steps, so the
broadcast touches nothing instead of recomputing the whole table (which is
what a plain cross-join broadcast — or the round-1 instance-recompute
emulation — would do).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node


class GradualBroadcastNode(Node):
    """Inputs: main table node; threshold node with columns
    (__l__, __v__, __u__). Output: main columns + ``apx_value``."""

    def __init__(self, graph, input_node, threshold_node,
                 name="GradualBroadcast"):
        out_cols = list(input_node.column_names) + ["apx_value"]
        super().__init__(graph, [input_node, threshold_node], out_cols, name)
        self._bounds: tuple | None = None  # (lower, value, upper)
        self._rows: dict[int, tuple] = {}      # key -> input row
        self._assigned: dict[int, Any] = {}    # key -> emitted apx value

    def reset(self):
        self._bounds = None
        self._rows = {}
        self._assigned = {}

    def step(self, time, ins):
        in_batch, thr_batch = ins
        out: list[tuple[int, tuple, int]] = []

        bounds_changed = False
        if thr_batch is not None and len(thr_batch):
            cols = self.inputs[1].column_names
            li, vi, ui = (cols.index(c) for c in ("__l__", "__v__", "__u__"))
            for key, row, diff in thr_batch.rows():
                if diff > 0:
                    self._bounds = (row[li], row[vi], row[ui])
                    bounds_changed = True

        if in_batch is not None and len(in_batch):
            cur = self._bounds[1] if self._bounds is not None else None
            rows = list(in_batch.rows())
            # deletions FIRST: a same-key update within one epoch arrives as
            # (+new, -old) in unspecified order; retracting before inserting
            # keeps _rows/_assigned and the emitted stream consistent
            for key, row, diff in rows:
                if diff < 0:
                    old_row = self._rows.pop(key, row)
                    old_v = self._assigned.pop(key, None)
                    out.append((key, old_row + (old_v,), -1))
            for key, row, diff in rows:
                if diff > 0:
                    self._rows[key] = row
                    self._assigned[key] = cur
                    out.append((key, row + (cur,), 1))

        if bounds_changed and self._bounds is not None:
            lo, val, up = self._bounds
            for key, v in self._assigned.items():
                in_band = (
                    v is not None
                    and lo is not None
                    and up is not None
                    and lo <= v <= up
                )
                if not in_band and v != val:
                    row = self._rows[key]
                    out.append((key, row + (v,), -1))
                    out.append((key, row + (val,), 1))
                    self._assigned[key] = val

        if not out:
            return None
        return Batch.from_rows(self.column_names, out)
