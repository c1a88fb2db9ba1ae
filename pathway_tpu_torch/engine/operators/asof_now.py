"""As-of-now join: left rows are answered once, against the right state at
their arrival epoch; later right-side updates do not retrigger old results.

Reference parity: ``stdlib/temporal/_asof_now_join.py`` + the engine's
``use_external_index_as_of_now`` request/response semantics (forget-style
query streams). Key mode defaults to preserving left ids (request/response
correlation).
"""

from __future__ import annotations

from collections import defaultdict

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.operators.join import JoinNode
from pathway_tpu_torch.engine.value import ERROR, hash_values
from pathway_tpu_torch.internals.errors import get_global_error_log


class AsofNowJoinNode(JoinNode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._left_emitted: dict[int, dict[int, tuple]] = {}

    _state_attrs = (
        "_left", "_right", "_left_jk", "_right_jk", "_left_emitted",
    )

    def reset(self):
        super().reset()
        self._left_emitted = {}

    def step(self, time, ins):
        lb, rb = ins
        # right side: just maintain state (no retriggering)
        if rb is not None:
            self._side_deltas(self._right, self._right_jk, rb, self.right_on)
        if lb is None:
            return None
        rows: list[tuple[int, tuple, int]] = []
        lnames = self.inputs[0].column_names
        # jk format matches _side_deltas' right buckets: bare value for a
        # single-column key, tuple otherwise
        on_idx = [lnames.index(c) for c in self.left_on]
        single = len(on_idx) == 1
        for key, lrow, diff in lb.rows():
            if diff > 0:
                if single:
                    jk = lrow[on_idx[0]]
                    bad = jk is ERROR
                else:
                    jk = tuple(lrow[i] for i in on_idx)
                    bad = any(v is ERROR for v in jk)
                if bad:
                    get_global_error_log().log("Error value in join key")
                    continue
                rbucket = self._right.get(jk, {})
                emitted: dict[int, tuple] = {}
                if rbucket:
                    for rk, rrow in rbucket.items():
                        out_key = self._out_key(key, rk)
                        emitted[out_key] = self._make_row(lrow, rrow)
                elif self.mode in ("left", "outer"):
                    emitted[self._out_key(key, None)] = self._make_row(lrow, None)
                for k, row in emitted.items():
                    rows.append((k, row, 1))
                self._left_emitted[key] = emitted
            else:
                emitted = self._left_emitted.pop(key, {})
                for k, row in emitted.items():
                    rows.append((k, row, -1))
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)
