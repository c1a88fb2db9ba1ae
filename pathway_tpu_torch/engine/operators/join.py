"""Incremental hash join.

Reference parity: ``join_tables`` (dataflow.rs:2270) with inner/left/right/
outer modes and id-preservation. Two execution strategies:

* **Bilinear delta** (inner joins, pair keys, insert-only deltas — the
  common streaming case): emits exactly the new pairs
  ``dL x R + L x dR - dL x dR`` per join key, O(delta * matches) like
  differential's arranged ``join_core`` — a single-row insert into a B-row
  bucket costs O(matches), not O(B).
* **Recompute + diff** (outer modes, retractions, id-preserving key
  modes): per affected join-key recompute diffed against the PRE-batch
  cross product, rebuilt from a per-step undo log — uniform across modes
  and retraction-correct, with no materialized emitted-pairs cache
  (memory O(input rows), not O(emitted pairs)).

Key extraction and row materialization are columnar: join-key columns come
straight out of the SoA ``Batch`` and all name->position lookups happen
once at construction, not per row.

Two loops run in the port's C++ engine library (``native/_engine.cpp``):
one side's batch applied to its buckets (single-column join keys), and an
inner join step's delta x bucket cross products with their pair keys. The
library builds at first use and a failed build raises. ``native=False``
runs both in Python, the same keys and rows (the tests' reference).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any

import numpy as np

from pathway_tpu_torch import native as native_mod
from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.state import rows_equal
from pathway_tpu_torch.engine.value import ERROR, hash_values
from pathway_tpu_torch.internals.errors import get_global_error_log


class JoinNode(Node):
    """Hash join on precomputed join-key columns.

    ``output_spec``: list of (out_name, side, src_col) with side in
    {"left", "right"}. ``key_mode``: "pair" | "left" | "right".
    """

    def __init__(
        self,
        graph,
        left,
        right,
        left_on: list[str],
        right_on: list[str],
        mode: str,  # inner | left | right | outer
        output_spec: list[tuple[str, str, str]],
        key_mode: str = "pair",
        exact_match: bool = False,
        name="Join",
        native: bool = True,
    ):
        super().__init__(graph, [left, right], [s[0] for s in output_spec], name)
        self.left_on = left_on
        self.right_on = right_on
        self.mode = mode
        self.output_spec = output_spec
        self.key_mode = key_mode
        self.native = native
        # name -> position resolved ONCE; per-row list.index() scans were
        # the dominant cost of large joins
        lnames = self.inputs[0].column_names
        rnames = self.inputs[1].column_names
        self._out_idx: list[tuple[bool, int]] = [
            (side == "left",
             (lnames if side == "left" else rnames).index(src))
            for _name, side, src in output_spec
        ]
        # C++ emitter spec (native join_ld_cross): which side + position
        # each output column reads from
        self._sides_bytes = bytes(
            1 if is_left else 0 for is_left, _ in self._out_idx
        )
        self._idx_list = [i for _, i in self._out_idx]
        # jk -> key -> row. NOTE: there is deliberately NO emitted-pairs
        # cache — after every step, downstream state for a jk equals
        # ``_cross`` of its current buckets (the fast paths emit exactly
        # the delta preserving that invariant), so the recompute path
        # derives "what was emitted" from pre-batch buckets rebuilt via
        # the per-step undo log. Memory stays O(input rows), not
        # O(emitted pairs) — the reference pays an arranged output trace
        # for the same job (dataflow.rs join_core arrangements).
        self._left: dict[Any, dict[int, tuple]] = defaultdict(dict)
        self._right: dict[Any, dict[int, tuple]] = defaultdict(dict)
        # row key -> its current jk, per side: a raw re-delivery (insert
        # of a live row key with NO retraction) that CHANGES the join key
        # must retract the stale row from its previous bucket
        self._left_jk: dict[int, Any] = {}
        self._right_jk: dict[int, Any] = {}

    _state_attrs = ("_left", "_right", "_left_jk", "_right_jk")

    def reset(self):
        self._left = defaultdict(dict)
        self._right = defaultdict(dict)
        self._left_jk = {}
        self._right_jk = {}

    def _side_deltas(
        self, state: dict, key2jk: dict, batch: Batch, on: list[str]
    ) -> tuple[dict[Any, list[tuple[int, tuple, int]]], set, dict]:
        """Apply one side's batch to its bucket state; returns the per-jk
        delta rows (columnar extraction — no per-row name lookups), the
        jks needing the recompute path — where an insert REPLACED an
        existing row key (the replaced row's pairs must retract), or —
        via ``key2jk`` — the PREVIOUS bucket of a re-delivered key whose
        join key changed — plus an undo log (jk -> [(key, old|None)])
        recording every bucket mutation so the recompute path can rebuild
        this side's pre-batch buckets."""
        cols = batch.cols
        col_lists = [c.tolist() for c in cols.values()]
        keys = batch.keys.tolist()
        diffs = batch.diffs.tolist()
        if self.native and len(on) == 1:
            # the whole pass (row assembly, bucket updates, per-jk delta
            # grouping, upsert-dirty detection, stale-bucket eviction,
            # undo logging) in one C loop
            jk_idx = list(cols).index(on[0])
            deltas, dirty_list, undo, n_err = native_mod.join_apply_side(
                state, key2jk, keys, diffs, tuple(col_lists), jk_idx, ERROR
            )
            for _ in range(n_err):
                get_global_error_log().log("Error value in join key")
            return deltas, set(dirty_list), undo
        rows = list(zip(*col_lists)) if col_lists else [()] * len(batch)
        if len(on) == 1:
            jks: list = cols[on[0]].tolist()
            single = True
        elif on:
            jks = list(zip(*[cols[c].tolist() for c in on]))
            single = False
        else:
            # empty join key = cross join: every row shares the () bucket
            jks = [()] * len(batch)
            single = False
        deltas: dict[Any, list[tuple[int, tuple, int]]] = defaultdict(list)
        dirty: set = set()
        undo: dict[Any, list] = defaultdict(list)
        for key, row, diff, jk in zip(keys, rows, diffs, jks):
            if (jk is ERROR) if single else any(v is ERROR for v in jk):
                get_global_error_log().log("Error value in join key")
                continue
            if diff > 0:
                old = key2jk.get(key)
                if old is not None and old != jk:
                    # re-delivery changed the join key: evict the stale
                    # row and recompute its old bucket
                    ob = state.get(old)
                    if ob is not None and key in ob:
                        undo[old].append((key, ob[key]))
                        del ob[key]
                        if not ob:
                            del state[old]
                    dirty.add(old)
                    deltas.setdefault(old, [])
                bucket = state[jk]
                prev = bucket.get(key)
                if prev is not None:
                    dirty.add(jk)  # upsert-style re-delivery of a row key
                undo[jk].append((key, prev))
                bucket[key] = row
                key2jk[key] = jk
                deltas[jk].append((key, row, diff))
            else:
                old = key2jk.pop(key, None)
                tgt = old if old is not None else jk
                bucket = state.get(tgt)
                if bucket is not None and key in bucket:
                    undo[tgt].append((key, bucket[key]))
                    del bucket[key]
                    if not bucket:
                        del state[tgt]
                deltas[tgt].append((key, row, diff))
                if old is not None and old != jk:
                    # retraction delivered with a stale join key: the row
                    # actually lived in ``old`` — recompute that bucket
                    dirty.add(tgt)
        return deltas, dirty, undo

    def _out_key(self, lk: int | None, rk: int | None) -> int:
        if self.key_mode == "left":
            return lk if lk is not None else rk
        if self.key_mode == "right":
            return rk if rk is not None else lk
        return hash_values(lk if lk is not None else 0, rk if rk is not None else 0)

    def _make_row(self, lrow: tuple | None, rrow: tuple | None) -> tuple:
        return tuple(
            (lrow[i] if lrow is not None else None)
            if is_left
            else (rrow[i] if rrow is not None else None)
            for is_left, i in self._out_idx
        )

    def _join_bucket(self, jk) -> dict[int, tuple]:
        """Full join output for one join key from current state."""
        return self._cross(self._left.get(jk, {}), self._right.get(jk, {}))

    @staticmethod
    def _pre_bucket(state: dict, jk, undo: dict) -> dict[int, tuple]:
        """This jk's bucket as it was BEFORE the current batch: replay the
        side's undo log in reverse over a copy of the current bucket."""
        cur = state.get(jk)
        pre = dict(cur) if cur else {}
        for key, old in reversed(undo.get(jk, ())):
            if old is None:
                pre.pop(key, None)
            else:
                pre[key] = old
        return pre

    def _cross(self, lbucket: dict, rbucket: dict) -> dict[int, tuple]:
        out: dict[int, tuple] = {}
        if lbucket and rbucket:
            for lk, lrow in lbucket.items():
                for rk, rrow in rbucket.items():
                    out[self._out_key(lk, rk)] = self._make_row(lrow, rrow)
        elif lbucket and self.mode in ("left", "outer"):
            for lk, lrow in lbucket.items():
                out[self._out_key(lk, None)] = self._make_row(lrow, None)
        elif rbucket and self.mode in ("right", "outer"):
            for rk, rrow in rbucket.items():
                out[self._out_key(None, rk)] = self._make_row(None, rrow)
        return out

    @staticmethod
    def _clean_delta(
        delta: "list[tuple[int, tuple, int]] | None", undo: "list | None"
    ) -> "list[tuple[int, tuple, int]] | None":
        """Normalize one jk's side delta for the weighted bilinear path:
        every row key at most once, and each retraction rewritten to
        carry the row ACTUALLY stored in the bucket (from the undo log —
        the delivered retraction row is what the source claims, the
        stored row is what downstream pairs were built from). Returns
        None when the delta needs the recompute path (duplicate keys, or
        a retraction that removed nothing)."""
        if not delta:
            return []
        if len(delta) == 1 and delta[0][2] > 0:
            return delta  # dominant streaming shape: one insert
        seen = set()
        out = []
        stored = None
        for key, row, d in delta:
            if key in seen:
                return None
            seen.add(key)
            if d > 0:
                out.append((key, row, d))
                continue
            if stored is None:
                stored = {
                    k: old for k, old in (undo or ()) if old is not None
                }
            srow = stored.get(key)
            if srow is None:
                return None  # retraction of an absent key: recompute
            out.append((key, srow, d))
        return out

    def step(self, time, ins):
        lb, rb = ins
        ldeltas, ldirty, lundo = (
            self._side_deltas(self._left, self._left_jk, lb, self.left_on)
            if lb is not None
            else ({}, set(), {})
        )
        rdeltas, rdirty, rundo = (
            self._side_deltas(self._right, self._right_jk, rb, self.right_on)
            if rb is not None
            else ({}, set(), {})
        )
        if not ldeltas and not rdeltas:
            return None
        dirty = ldirty | rdirty
        rows: list[tuple[int, tuple, int]] = []
        pairs: list[tuple[int, int, tuple, int]] = []  # (lk, rk, row, diff)
        native = self.native and self.mode == "inner"
        works: list = []  # (delta, bucket[, swapped]) per fast jk term
        fast_ok = self.mode == "inner" and self.key_mode == "pair"
        out_idx = self._out_idx
        jks = (
            ldeltas.keys() | rdeltas.keys()
            if ldeltas and rdeltas
            else (ldeltas or rdeltas)
        )
        for jk in jks:
            ld = ldeltas.get(jk) if ldeltas else None
            rd = rdeltas.get(jk) if rdeltas else None
            if fast_ok and jk not in dirty:
                # weighted bilinear delta: dJ = dL x R_post + L_pre x dR
                # — exact for ANY mix of inserts and retractions (each
                # side's keys unique, retractions carry stored rows), so
                # churn-heavy streams stay O(delta x matches) instead of
                # falling back to per-jk recompute
                ld2 = self._clean_delta(ld, lundo.get(jk))
                rd2 = self._clean_delta(rd, rundo.get(jk))
                if ld2 is not None and rd2 is not None:
                    if rd2:
                        lpre = self._pre_bucket(self._left, jk, lundo)
                        if lpre:
                            if native:
                                works.append((rd2, lpre, True))
                            else:
                                append = pairs.append
                                for rk, rrow, d in rd2:
                                    for lk, lrow in lpre.items():
                                        append((lk, rk, tuple(
                                            [lrow[i] if il else rrow[i]
                                             for il, i in out_idx]
                                        ), d))
                    if ld2:
                        rbucket = self._right.get(jk)
                        if rbucket:
                            if native:
                                works.append((ld2, rbucket))
                            else:
                                append = pairs.append
                                for lk, lrow, d in ld2:
                                    for rk, rrow in rbucket.items():
                                        append((lk, rk, tuple(
                                            [lrow[i] if il else rrow[i]
                                             for il, i in out_idx]
                                        ), d))
                    continue
            # recompute path: diff the cross product of pre-batch buckets
            # (rebuilt via the undo logs) against the current one — what
            # was previously emitted IS the pre-batch cross (invariant
            # kept by every emission path)
            new_out = self._join_bucket(jk)
            old_out = self._cross(
                self._pre_bucket(self._left, jk, lundo),
                self._pre_bucket(self._right, jk, rundo),
            )
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
        fast_batch = None
        if works:
            # the whole step's fast-path cross products in one C pass:
            # per-OUTPUT-COLUMN value lists plus the hashed pair keys and
            # weights come back ready to wrap in a Batch — no row tuples,
            # no re-split, no second hashing pass
            col_lists, keys_buf, diffs_buf = native_mod.join_ld_cross(
                works, self._sides_bytes, self._idx_list
            )
            n = len(keys_buf) >> 3
            if n:
                oks = np.frombuffer(keys_buf, dtype=np.uint64)
                cols = {}
                for name, lst in zip(self.column_names, col_lists):
                    arr = np.empty(n, dtype=object)
                    arr[:] = lst
                    cols[name] = arr
                fast_batch = Batch(
                    oks, cols, np.frombuffer(diffs_buf, dtype=np.int64)
                )
        if pairs:
            # one vectorized Key::for_values pass over all fast-path pairs
            # (C++ column hash + numpy mixing) instead of a Python
            # hash_values call per output row
            from pathway_tpu_torch.engine.value import keys_for_value_columns

            oks = keys_for_value_columns(
                [
                    np.array([p[0] for p in pairs], dtype=object),
                    np.array([p[1] for p in pairs], dtype=object),
                ],
                len(pairs),
            )
            for (_lk, _rk, row, d), ok in zip(pairs, oks.tolist()):
                rows.append((ok, row, d))
        if rows:
            row_batch = Batch.from_rows(self.column_names, rows)
            if fast_batch is None:
                return row_batch
            from pathway_tpu_torch.engine.batch import concat_batches

            return concat_batches([fast_batch, row_batch])
        return fast_batch
