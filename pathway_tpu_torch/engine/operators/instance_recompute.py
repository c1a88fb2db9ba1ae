"""Generic per-instance recompute operator.

Several temporal operations (asof/interval/window joins, session windows) are
defined per *instance* (colocation group) over the full set of rows in that
instance. The reference implements each with bespoke differential operators
(``_asof_join.py``, ``_interval_join.py``, session merging); here a single
engine node maintains both inputs' states partitioned by instance and, on any
change, recomputes the instance's output with a plain Python/numpy function
and emits the diff. Correct under retraction by construction; per-instance
cost is the recompute — the vectorized function sees whole column arrays.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.state import rows_equal
from pathway_tpu_torch.engine.value import ERROR
from pathway_tpu_torch.internals.errors import get_global_error_log


class InstanceRecomputeNode(Node):
    """``compute(instance, left_rows, right_rows) -> dict[key, row]``.

    ``left_rows``/``right_rows``: dict[key, row tuple]. For unary operators
    pass one input; right_rows is then None.
    """

    def __init__(
        self,
        graph,
        inputs: list[Node],
        instance_cols: list[str],  # instance column name per input
        out_columns: list[str],
        compute: Callable[..., dict[int, tuple]],
        name="InstanceRecompute",
    ):
        super().__init__(graph, inputs, out_columns, name)
        self.instance_cols = instance_cols
        self.compute = compute
        self._states: list[dict[Any, dict[int, tuple]]] = [
            defaultdict(dict) for _ in inputs
        ]
        self._emitted: dict[Any, dict[int, tuple]] = defaultdict(dict)


    def reset(self):
        self._states = [defaultdict(dict) for _ in self.inputs]
        self._emitted = defaultdict(dict)

    def step(self, time, ins):
        affected: set = set()
        for idx, (state, batch) in enumerate(zip(self._states, ins)):
            if batch is None:
                continue
            names = self.inputs[idx].column_names
            ii = names.index(self.instance_cols[idx])
            for key, row, diff in batch.rows():
                inst = row[ii]
                if inst is ERROR:
                    get_global_error_log().log("Error value in instance column")
                    continue
                bucket = state[inst]
                if diff > 0:
                    bucket[key] = row
                else:
                    bucket.pop(key, None)
                affected.add(inst)
        if not affected:
            return None
        rows = []
        for inst in affected:
            args = [st.get(inst, {}) for st in self._states]
            try:
                new_out = self.compute(inst, *args)
            except Exception as exc:  # noqa: BLE001
                get_global_error_log().log(
                    f"instance recompute error: {type(exc).__name__}: {exc}"
                )
                continue
            old_out = self._emitted.get(inst, {})
            for k, row in old_out.items():
                nrow = new_out.get(k)
                if nrow is None:
                    rows.append((k, row, -1))
                elif not rows_equal(nrow, row):
                    rows.append((k, row, -1))
                    rows.append((k, nrow, 1))
            for k, row in new_out.items():
                if k not in old_out:
                    rows.append((k, row, 1))
            if new_out:
                self._emitted[inst] = new_out
            else:
                self._emitted.pop(inst, None)
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)
