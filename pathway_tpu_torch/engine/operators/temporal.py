"""Temporal-behavior operators: buffer (postpone), forget, freeze, and sort
(prev/next pointers).

Reference parity: ``src/engine/dataflow/operators/time_column.rs``
(postpone_core:380, TimeColumnForget:556, TimeColumnFreeze:631) and
``prev_next.rs`` (add_prev_next_pointers:770). The watermark is the max value
seen in the designated time column — identical to the reference's
self-compaction time semantics.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine import probes
from pathway_tpu_torch.engine.state import rows_equal
from pathway_tpu_torch.engine.value import ERROR, Pointer, hash_values
from pathway_tpu_torch.internals.errors import get_global_error_log


def _numeric(v) -> float | None:
    """Best-effort float view of a time-column value (numbers and
    datetime-likes); None for anything else — watermark lag is telemetry,
    not semantics, so non-numeric time columns just skip the gauge."""
    try:
        return float(v)
    except (TypeError, ValueError):
        ts = getattr(v, "timestamp", None)
        if callable(ts):
            try:
                return float(ts())
            except Exception:  # noqa: BLE001 - telemetry must not raise
                return None
        return None


def _record_temporal(node: Node, held_rows: int, min_threshold) -> None:
    """Held-backlog + watermark-lag gauges for a stateful temporal node.
    Gated on the owning scheduler's cached op-metrics switch, so the
    per-step cost with telemetry off is one attribute read."""
    sched = getattr(node, "scheduler", None)
    if sched is None or not getattr(sched, "op_metrics", False):
        return
    lag = None
    if min_threshold is not None and node._watermark is not None:
        wm = _numeric(node._watermark)
        thr = _numeric(min_threshold)
        if wm is not None and thr is not None:
            lag = thr - wm
    probes.record_watermark(node.name, held_rows, lag)


class BufferNode(Node):
    """Postpone rows until watermark(time_col) >= row.threshold."""

    _state_attrs = ("_held", "_watermark")

    def __init__(self, graph, input_node, threshold_col: str, time_col: str, name="Buffer"):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.threshold_col = threshold_col
        self.time_col = time_col
        self._held: dict[int, list[tuple[tuple, int]]] = {}
        self._watermark: Any = None


    def reset(self):
        self._held = {}
        self._watermark = None

    def step(self, time, ins):
        (batch,) = ins
        names = self.inputs[0].column_names
        ti = names.index(self.time_col)
        hi = names.index(self.threshold_col)
        out_rows: list[tuple[int, tuple, int]] = []
        if batch is not None and len(batch) > 0:
            for key, row, diff in batch.rows():
                tv = row[ti]
                if tv is not ERROR and (
                    self._watermark is None or tv > self._watermark
                ):
                    self._watermark = tv
            for key, row, diff in batch.rows():
                thr = row[hi]
                if thr is ERROR:
                    get_global_error_log().log("Error in buffer threshold column")
                    continue
                if self._watermark is not None and thr <= self._watermark:
                    out_rows.append((key, row, diff))
                else:
                    self._held.setdefault(key, []).append((row, diff))
        # release held rows whose threshold passed
        if self._watermark is not None and self._held:
            released = []
            for key, entries in list(self._held.items()):
                keep = []
                for row, diff in entries:
                    if row[hi] <= self._watermark:
                        released.append((key, row, diff))
                    else:
                        keep.append((row, diff))
                if keep:
                    self._held[key] = keep
                else:
                    del self._held[key]
            out_rows.extend(released)
        held = sum(len(entries) for entries in self._held.values())
        min_thr = None
        if held:
            thrs = [
                row[hi]
                for entries in self._held.values()
                for row, _diff in entries
                if row[hi] is not ERROR
            ]
            min_thr = min(thrs) if thrs else None
        _record_temporal(self, held, min_thr)
        if not out_rows:
            return None
        return Batch.from_rows(names, out_rows)

    def flush(self) -> list[tuple[int, tuple, int]]:
        """End-of-stream: release everything (static mode semantics)."""
        out = []
        for key, entries in self._held.items():
            for row, diff in entries:
                out.append((key, row, diff))
        self._held = {}
        return out

    def on_time_end(self, time):
        return []


class ForgetNode(Node):
    """Retract rows once watermark(time_col) >= row.threshold; optionally
    marks forgetting records instead of silently retracting."""

    _state_attrs = ("_alive", "_watermark")

    def __init__(
        self,
        graph,
        input_node,
        threshold_col: str,
        time_col: str,
        mark_forgetting_records: bool = False,
        name="Forget",
    ):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.threshold_col = threshold_col
        self.time_col = time_col
        self.mark = mark_forgetting_records
        self._alive: dict[int, list[tuple]] = {}
        self._watermark: Any = None


    def reset(self):
        self._alive = {}
        self._watermark = None

    def step(self, time, ins):
        (batch,) = ins
        names = self.inputs[0].column_names
        ti = names.index(self.time_col)
        hi = names.index(self.threshold_col)
        out_rows: list[tuple[int, tuple, int]] = []
        if batch is not None and len(batch) > 0:
            for key, row, diff in batch.rows():
                tv = row[ti]
                if tv is not ERROR and (
                    self._watermark is None or tv > self._watermark
                ):
                    self._watermark = tv
            for key, row, diff in batch.rows():
                thr = row[hi]
                if thr is not ERROR and self._watermark is not None and thr <= self._watermark:
                    continue  # already beyond horizon: never emitted
                out_rows.append((key, row, diff))
                if diff > 0:
                    self._alive.setdefault(key, []).append(row)
                else:
                    lst = self._alive.get(key, [])
                    for i, r in enumerate(lst):
                        if rows_equal(r, row):
                            del lst[i]
                            break
        # retract rows that crossed the horizon
        if self._watermark is not None and self._alive:
            for key, rows_ in list(self._alive.items()):
                keep = []
                for row in rows_:
                    thr = row[hi]
                    if thr is not ERROR and thr <= self._watermark:
                        out_rows.append((key, row, -1))
                    else:
                        keep.append(row)
                if keep:
                    self._alive[key] = keep
                else:
                    del self._alive[key]
        alive = sum(len(rows_) for rows_ in self._alive.values())
        min_thr = None
        if alive:
            thrs = [
                row[hi]
                for rows_ in self._alive.values()
                for row in rows_
                if row[hi] is not ERROR
            ]
            min_thr = min(thrs) if thrs else None
        _record_temporal(self, alive, min_thr)
        if not out_rows:
            return None
        return Batch.from_rows(names, out_rows)


class FreezeNode(Node):
    """Drop (ignore) updates arriving after their threshold passed."""

    _state_attrs = ("_watermark",)

    def __init__(
        self,
        graph,
        input_node,
        threshold_col: str,
        time_col: str,
        name="Freeze",
    ):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.threshold_col = threshold_col
        self.time_col = time_col
        self._watermark: Any = None


    def reset(self):
        self._watermark = None

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        names = self.inputs[0].column_names
        ti = names.index(self.time_col)
        hi = names.index(self.threshold_col)
        prev_watermark = self._watermark
        for key, row, diff in batch.rows():
            tv = row[ti]
            if tv is not ERROR and (self._watermark is None or tv > self._watermark):
                self._watermark = tv
        out = []
        for key, row, diff in batch.rows():
            thr = row[hi]
            if (
                thr is not ERROR
                and prev_watermark is not None
                and thr <= prev_watermark
            ):
                continue  # late: frozen
            out.append((key, row, diff))
        if not out:
            return None
        return Batch.from_rows(names, out)


class SortNode(Node):
    """Maintains prev/next pointers per instance over a sortable key column.

    Output columns: ``prev``, ``next`` (Optional[Pointer]) keyed like the
    input. Affected instances are re-sorted wholesale and diffed — the
    vectorized analog of the reference's bidirectional-cursor incremental
    maintenance (prev_next.rs).
    """

    _state_attrs = ("_rows", "_emitted")

    def __init__(self, graph, input_node, key_col: str, instance_col: str | None, name="Sort"):
        super().__init__(graph, [input_node], ["prev", "next"], name)
        self.key_col = key_col
        self.instance_col = instance_col
        self._rows: dict[int, tuple] = {}  # key -> (sort_value, instance)
        self._emitted: dict[int, tuple] = {}


    def reset(self):
        self._rows = {}
        self._emitted = {}

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        names = self.inputs[0].column_names
        ki = names.index(self.key_col)
        ii = names.index(self.instance_col) if self.instance_col else None
        affected_instances = set()
        for key, row, diff in batch.rows():
            inst = row[ii] if ii is not None else None
            if diff > 0:
                self._rows[key] = (row[ki], inst)
            else:
                self._rows.pop(key, None)
            affected_instances.add(inst)
        # recompute pointers for affected instances
        new_out: dict[int, tuple] = {}
        for k, (sv, inst) in self._rows.items():
            if inst in affected_instances:
                new_out[k] = None  # placeholder, filled below
        by_inst: dict[Any, list] = {}
        for k, (sv, inst) in self._rows.items():
            if inst in affected_instances:
                by_inst.setdefault(inst, []).append((sv, k))
        for inst, entries in by_inst.items():
            entries.sort(key=lambda t: (t[0], t[1]))
            for i, (sv, k) in enumerate(entries):
                prev_ptr = Pointer(entries[i - 1][1]) if i > 0 else None
                next_ptr = (
                    Pointer(entries[i + 1][1]) if i + 1 < len(entries) else None
                )
                new_out[k] = (prev_ptr, next_ptr)
        rows = []
        # diff against previously emitted for affected instances
        for k, old in list(self._emitted.items()):
            info = self._rows.get(k)
            inst = info[1] if info else None
            if (info is None or inst in affected_instances) and k not in new_out:
                if info is None:  # row deleted
                    rows.append((k, old, -1))
                    del self._emitted[k]
        for k, new in new_out.items():
            old = self._emitted.get(k)
            if rows_equal(old, new):
                continue
            if old is not None:
                rows.append((k, old, -1))
            rows.append((k, new, 1))
            self._emitted[k] = new
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)
