"""Core engine operators: input, rowwise select, filter, reindex, concat,
universe ops, update_rows/cells, ix (pointer join), flatten.

Reference parity: ``src/engine/dataflow.rs`` op impls (expression_table:1246,
filter:1495, reindex, concat, update_*, ix, flatten) re-derived for the
columnar epoch-synchronous engine.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.batch import Batch, concat_batches, consolidate
from pathway_tpu_torch.engine.expression_eval import (
    EvalEnv,
    ExpressionEvaluator,
    error_mask,
    eval_exprs,
)
from pathway_tpu_torch.engine.graph import EngineGraph, Node
from pathway_tpu_torch.engine.state import (
    DuplicateKeyError,
    MultisetState,
    TableState,
    rows_equal,
)
from pathway_tpu_torch.engine.value import ERROR, Pointer, hash_keys_with
from pathway_tpu_torch.internals.errors import get_global_error_log


def diff_tables(
    prev: dict[int, tuple], new: dict[int, tuple], column_names: list[str]
) -> Batch | None:
    """Delta batch turning table ``prev`` into ``new`` (keys compared)."""
    rows: list[tuple[int, tuple, int]] = []
    for k, row in prev.items():
        nrow = new.get(k)
        if nrow is None:
            rows.append((k, row, -1))
        elif not rows_equal(nrow, row):
            rows.append((k, row, -1))
            rows.append((k, nrow, 1))
    for k, row in new.items():
        if k not in prev:
            rows.append((k, row, 1))
    if not rows:
        return None
    return Batch.from_rows(column_names, rows)


class InputNode(Node):
    """A source: data arrives via scheduler injection (sessions/connectors)."""

    def __init__(self, graph: EngineGraph, column_names: list[str], name="Input"):
        super().__init__(graph, [], column_names, name)

    def step(self, time, ins):
        return None  # injected batches are merged by the scheduler


class StatefulNode(Node):
    """Base for operators that materialize their output (chaining diffs)."""


    def __init__(self, graph, inputs, column_names, name=""):
        super().__init__(graph, inputs, column_names, name)
        self._in_states = [TableState(i.column_names) for i in inputs]

    def reset(self):
        self._in_states = [TableState(i.column_names) for i in self.inputs]


def _contains_nondeterministic(expr) -> bool:
    from pathway_tpu_torch.internals import expression as expr_mod

    if isinstance(
        expr, (expr_mod.ApplyExpression, expr_mod.AsyncApplyExpression)
    ) and not getattr(expr, "_deterministic", True):
        return True
    return any(
        _contains_nondeterministic(d)
        for d in expr._deps()
        if hasattr(d, "_deps")
    )


class RowwiseNode(Node):
    """Vectorized expression evaluation over input deltas (select/with_columns).

    Normally stateless: a delta row in produces a delta row out with the same
    key and diff. When any expression contains a NON-DETERMINISTIC UDF
    (``deterministic=False``), the node caches each inserted row's outputs so
    a later retraction replays the exact values produced at insertion —
    re-running the UDF could yield different values, and the retraction would
    then fail to cancel downstream state (reference
    ``map_named_async_with_consistent_deletions``, ``operators.rs:320-380``).
    """

    def __init__(self, graph, input_node, expressions: dict[str, Any], name="Rowwise",
                 replay_retractions: bool = False):
        super().__init__(graph, [input_node], list(expressions.keys()), name)
        self.expressions = expressions
        self._nondet = any(
            _contains_nondeterministic(e) for e in expressions.values()
        )
        # the replay cache is load-bearing (a retraction must replay what a
        # non-deterministic UDF gave) only here; replay_retractions below
        # uses it to save device work, and a miss there recomputes
        self._stateful = self._nondet
        # key -> [refcount, {out_col: value}]
        self._replay_cache: dict[int, list] = {}
        # top-level deferred two-phase applies (fully-async executor): the
        # epoch submits their chunks and returns WITHOUT waiting for the
        # device — a drainer thread resolves off-epoch and injects the
        # completed batch at a later engine time, so the scheduler keeps
        # ingesting/stepping while the accelerator computes (reference
        # fully-async UDF semantics, src/python_api/mod.rs fully_async;
        # here fused with the two-phase device dispatch protocol)
        self._deferred_names = {
            name
            for name, e in expressions.items()
            if getattr(e, "_deferred", False)
            and getattr(e, "_batched", False)
            and getattr(e, "_submit_fun", None) is not None
            and getattr(e, "_resolve_fun", None) is not None
        }
        self._drain_queue = None
        self._drain_thread = None
        # replay_retractions: a retraction takes the values its insertion
        # produced (the replay cache) even when every expression is
        # deterministic, so a device UDF runs once a row; the deferred path
        # keeps its own semantics
        if replay_retractions and not self._deferred_names:
            self._nondet = True


    def is_stateful(self) -> bool:  # only when the cache is load-bearing
        return self._stateful

    def reset(self):
        super().reset()
        self._replay_cache = {}
        if self._drain_queue is not None:
            # release the previous run's drainer. A clean run finishes
            # with the queue empty (async_inflight hits zero first), but
            # a run killed by an epoch exception can leave items behind —
            # discard them so the stale thread doesn't keep resolving on
            # the device alongside the new run's drainer
            import queue as queue_mod

            try:
                while True:
                    self._drain_queue.get_nowait()
            except queue_mod.Empty:
                pass
            self._drain_queue.put(None)
            self._drain_queue = None
            self._drain_thread = None

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        if (
            self._deferred_names
            and not self._nondet
            and getattr(self, "scheduler", None) is not None
            and getattr(self.scheduler, "allow_deferred", False)
        ):
            return self._step_deferred(batch)
        if not self._nondet:
            out_cols = eval_exprs(
                batch.cols, batch.keys, len(batch), self.expressions
            )
            return Batch(batch.keys, out_cols, batch.diffs)
        return self._step_consistent(batch)

    # ---- deferred (fully-async) two-phase path ---------------------------
    def _step_deferred(self, batch):
        from pathway_tpu_torch.engine.expression_eval import (
            scan_apply_rows,
            submit_apply_chunks,
        )

        n = len(batch)
        env = EvalEnv(batch.cols, batch.keys, n)
        ev = ExpressionEvaluator(env)
        out_cols: dict[str, np.ndarray] = {}
        pending = []
        for name, expr in self.expressions.items():
            if name in self._deferred_names:
                args = [ev.eval(a) for a in expr._args]
                kwargs = {k: ev.eval(v) for k, v in expr._kwargs.items()}
                out = np.empty(n, dtype=object)
                todo = scan_apply_rows(expr, args, kwargs, n, out)
                chunk = expr._max_batch_size or len(todo) or 1
                handles = submit_apply_chunks(
                    expr, args, kwargs, todo, chunk, out
                )
                out_cols[name] = out
                pending.append((expr, out, handles))
            else:
                out_cols[name] = ev.eval(expr)
        # EVERY batch rides the queue once the node is deferred — emitting
        # "nothing to resolve" batches inline would let them overtake
        # earlier in-flight batches (a retraction must never pass its
        # insert downstream)
        sched = self.scheduler
        sched.async_begin()
        self._ensure_drainer()
        self._drain_queue.put((sched, batch.keys, batch.diffs, out_cols, pending))
        return None

    def _ensure_drainer(self):
        import queue
        import threading

        if self._drain_thread is None or not self._drain_thread.is_alive():
            self._drain_queue = queue.Queue()
            self._drain_thread = threading.Thread(
                target=self._drain_loop,
                args=(self._drain_queue,),
                daemon=True,
                name=f"pathway:defer:{self.name}",
            )
            self._drain_thread.start()

    def _drain_loop(self, q):
        from pathway_tpu_torch.engine.clock import kick_heartbeats, next_commit_time
        from pathway_tpu_torch.engine.expression_eval import finish_apply_chunks

        while True:
            item = q.get()
            if item is None:
                return
            sched, keys, diffs, out_cols, pending = item
            try:
                # Split-safety: per-chunk injection reorders rows of one
                # batch across engine times, which is only sound when no
                # key can appear twice with conflicting signs — i.e. the
                # batch is insert-only (a consolidated insert-only batch
                # has each key at most once). A batch carrying any
                # retraction resolves chunk-by-chunk for the same device
                # overlap but injects ONCE, preserving intra-batch order.
                insert_only = bool((diffs > 0).all())
                if len(pending) == 1 and insert_only:
                    # the common streaming case drains CHUNK BY CHUNK,
                    # injecting each chunk's rows as soon as its device
                    # result lands: downstream host work (joins, index
                    # appends, sinks) for chunk i overlaps the chip
                    # computing chunk i+1 — the whole point of deferral.
                    # (One resolve per chunk costs a fixed dispatch RTT
                    # each; measured well under the overlap it buys.)
                    #
                    # Coalescing (EngineConfig.drain_coalesce, default on):
                    # when the scheduler already has injected epochs
                    # WAITING, per-chunk injection only multiplies epochs —
                    # each one pays the full downstream spine + close-out
                    # sweep — without buying any extra overlap. So resolved
                    # chunks accumulate into ONE columnar batch (one engine
                    # epoch) until the engine runs dry or the group cap is
                    # hit; a hungry engine still gets every chunk
                    # immediately, so the kill switch only matters when the
                    # engine, not the device, is the bottleneck.
                    group_max = (
                        sched.config.drain_coalesce_max
                        if sched.config.drain_coalesce
                        else 1
                    )
                    expr, out, handles = pending[0]
                    emitted = np.zeros(len(keys), dtype=bool)
                    group: list[np.ndarray] = []
                    for idx, h in handles:
                        finish_apply_chunks(expr, out, [(idx, h)])
                        sel = np.asarray(idx, dtype=np.int64)
                        emitted[sel] = True
                        group.append(sel)
                        if (
                            len(group) >= group_max
                            or sched.pending_backlog() == 0
                        ):
                            merged = (
                                group[0] if len(group) == 1
                                else np.concatenate(group)
                            )
                            self._inject_rows(
                                sched, keys, diffs, out_cols, merged
                            )
                            kick_heartbeats()
                            group = []
                    if group:
                        merged = (
                            group[0] if len(group) == 1
                            else np.concatenate(group)
                        )
                        self._inject_rows(sched, keys, diffs, out_cols, merged)
                        kick_heartbeats()
                    rest = np.nonzero(~emitted)[0]
                    if len(rest):
                        # rows with no device work (ERROR / propagated
                        # None) flush last; inserts never conflict
                        self._inject_rows(sched, keys, diffs, out_cols, rest)
                        kick_heartbeats()
                else:
                    for expr, out, handles in pending:
                        # chunk-at-a-time drain: the GIL is released while
                        # the chip computes, so the scheduler keeps pumping
                        for idx_h in handles:
                            finish_apply_chunks(expr, out, [idx_h])
                    sched.inject(
                        self, next_commit_time(), Batch(keys, out_cols, diffs)
                    )
                    kick_heartbeats()
            except Exception as exc:  # noqa: BLE001 - drop batch, keep engine
                get_global_error_log().log(
                    f"deferred udf drain error: {type(exc).__name__}: {exc}"
                )
            finally:
                sched.async_done()

    def _inject_rows(self, sched, keys, diffs, out_cols, sel) -> None:
        from pathway_tpu_torch.engine.clock import next_commit_time

        sub = {name: col[sel] for name, col in out_cols.items()}
        sched.inject(self, next_commit_time(), Batch(keys[sel], sub, diffs[sel]))
        # deferred emissions bypass the scheduler's step accounting (the
        # originating step returned None) — count the injected rows as
        # this operator's output so `op_rows{direction=out}` stays honest
        if getattr(sched, "op_metrics", False):
            from pathway_tpu_torch.engine import probes

            probes.REGISTRY.counter_add(
                "op_rows", int(len(sel)),
                operator=self.name, direction="out",
            )
            probes.record_backlog("pending_epochs", sched.pending_backlog())

    def _step_consistent(self, batch):
        from pathway_tpu_torch.engine.value import hash_values

        names = list(self.expressions.keys())
        in_names = self.inputs[0].column_names
        n = len(batch)
        keys = batch.keys
        diffs = batch.diffs
        in_rows = [
            tuple(batch.cols[c][i] for c in in_names) for i in range(n)
        ]
        # cache entries are keyed by (row key, input-row hash): a key
        # re-inserted with different content gets its own entry, and the
        # retraction (which carries the original input row) finds the value
        # produced at that row's insertion
        ckeys = []
        for i in range(n):
            try:
                rh = hash_values(*in_rows[i])
            except Exception:  # noqa: BLE001 — unhashable exotic values
                rh = 0
            ckeys.append((int(keys[i]), rh))

        # plan in row order against simulated cache membership, so a
        # same-batch insert-then-delete replays the insert's fresh value and
        # a delete-then-insert recomputes after eviction
        membership = {
            ck: entry[0] for ck, entry in self._replay_cache.items()
        }
        live = np.zeros(n, dtype=bool)
        for i in range(n):
            ck = ckeys[i]
            d = int(diffs[i])
            present = membership.get(ck, 0) > 0
            if present:
                membership[ck] = membership.get(ck, 0) + d
            elif d > 0:
                live[i] = True
                membership[ck] = d
            else:
                # retraction with no cached insertion (e.g. restart without
                # operator state): best-effort live recompute
                live[i] = True

        out_cols = {name: np.empty(n, dtype=object) for name in names}
        live_idx = np.nonzero(live)[0]
        if len(live_idx):
            sub = batch.take(live)
            env = EvalEnv(sub.cols, sub.keys, len(sub))
            ev = ExpressionEvaluator(env)
            for name, expr in self.expressions.items():
                vals = ev.eval(expr)
                for j, i in enumerate(live_idx):
                    out_cols[name][i] = vals[j]

        for i in range(n):
            ck = ckeys[i]
            d = int(diffs[i])
            entry = self._replay_cache.get(ck)
            if live[i]:
                if d > 0:
                    if entry is None:
                        self._replay_cache[ck] = [
                            d, {name: out_cols[name][i] for name in names}
                        ]
                    else:
                        # identical row re-inserted: replay the stored value
                        # so every copy downstream is byte-identical
                        for name in names:
                            out_cols[name][i] = entry[1][name]
                        entry[0] += d
                # live deletions (fallback path) emit the recomputed value
            else:
                for name in names:
                    out_cols[name][i] = entry[1][name]
                entry[0] += d
                if entry[0] <= 0:
                    del self._replay_cache[ck]
        return Batch(keys, out_cols, diffs)


class FilterNode(Node):
    """Keep rows where the predicate column is True; ERROR rows are dropped
    and logged (reference semantics)."""

    def __init__(self, graph, input_node, predicate, name="Filter"):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.predicate = predicate

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        env = EvalEnv(batch.cols, batch.keys, len(batch))
        cond = ExpressionEvaluator(env).eval(self.predicate)
        mask = np.zeros(len(batch), dtype=bool)
        for i, v in enumerate(cond):
            if v is True:
                mask[i] = True
            elif v is ERROR:
                get_global_error_log().log("Error value in filter condition")
        if not mask.any():
            return None
        return batch.take(mask)


class RemoveErrorsNode(Node):
    """Drop rows with an ERROR value in any column (reference
    ``Table.remove_errors`` / ``RemoveErrorsContext``, table.py:2491)."""

    def __init__(self, graph, input_node, name="RemoveErrors"):
        super().__init__(graph, [input_node], input_node.column_names, name)

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        mask = np.ones(len(batch), dtype=bool)
        for col in batch.cols.values():
            if col.dtype == object:
                mask &= ~error_mask(col)
        if mask.all():
            return batch
        if not mask.any():
            return None
        return batch.take(mask)


class SelectColumnsNode(Node):
    """Project/rename columns (cheap, array-sharing)."""

    def __init__(self, graph, input_node, mapping: dict[str, str], name="Select"):
        # mapping: output_name -> input_name
        super().__init__(graph, [input_node], list(mapping.keys()), name)
        self.mapping = mapping

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        return Batch(
            batch.keys,
            {out: batch.cols[src] for out, src in self.mapping.items()},
            batch.diffs,
        )


# ------------------------------------------------------------------------- #
# chain fusion stages (engine/graph.py:fuse_chains)
#
# A "stage" is the fused form of one stateless per-row operator: a closure
# (keys, cols, diffs) -> (keys, cols, diffs) | None operating on the raw
# batch arrays. Stages run back-to-back inside FusedChainNode.step with no
# intermediate Batch objects and no per-member consolidate — but in chain
# order with masks applied immediately, so values, dropped rows and error
# logging are byte-identical to the unfused graph.


def _rowwise_stage(node: "RowwiseNode"):
    exprs = node.expressions

    def stage(keys, cols, diffs):
        return keys, eval_exprs(cols, keys, len(keys), exprs), diffs

    return stage


def _filter_stage(node: "FilterNode"):
    predicate = node.predicate

    def stage(keys, cols, diffs):
        n = len(keys)
        env = EvalEnv(cols, keys, n)
        cond = ExpressionEvaluator(env).eval(predicate)
        mask = np.zeros(n, dtype=bool)
        for i, v in enumerate(cond):
            if v is True:
                mask[i] = True
            elif v is ERROR:
                get_global_error_log().log("Error value in filter condition")
        if not mask.any():
            return None
        if mask.all():
            return keys, cols, diffs
        idx = np.nonzero(mask)[0]
        return keys[idx], {n_: c[idx] for n_, c in cols.items()}, diffs[idx]

    return stage


def _remove_errors_stage(node: "RemoveErrorsNode"):
    def stage(keys, cols, diffs):
        mask = np.ones(len(keys), dtype=bool)
        for col in cols.values():
            if col.dtype == object:
                mask &= ~error_mask(col)
        if mask.all():
            return keys, cols, diffs
        if not mask.any():
            return None
        idx = np.nonzero(mask)[0]
        return keys[idx], {n_: c[idx] for n_, c in cols.items()}, diffs[idx]

    return stage


def _select_columns_stage(node: "SelectColumnsNode"):
    mapping = node.mapping

    def stage(keys, cols, diffs):
        return keys, {out: cols[src] for out, src in mapping.items()}, diffs

    return stage


def fusable_stage(node: Node):
    """Return the fused stage closure for ``node`` if it is a stateless
    per-row operator eligible for chain fusion, else None.

    Eligibility is strict: exactly one input, the base-class ``on_time_end``
    (members are skipped in the scheduler's end-of-epoch sweep), no flush
    hook (run.py's flush loop only sees scheduled nodes), and no per-row
    state — which excludes RowwiseNode with non-deterministic UDFs (replay
    cache) or deferred two-phase applies (drainer injects under the node's
    own id, which a fused intermediate no longer has)."""
    if len(node.inputs) != 1:
        return None
    if type(node).on_time_end is not Node.on_time_end:
        return None
    if getattr(node, "flush", None) is not None:
        return None
    # exact types only: a subclass may override step() with new semantics
    if type(node) is RowwiseNode:
        if node._nondet or node._deferred_names:
            return None
        return _rowwise_stage(node)
    if type(node) is FilterNode:
        return _filter_stage(node)
    if type(node) is RemoveErrorsNode:
        return _remove_errors_stage(node)
    if type(node) is SelectColumnsNode:
        return _select_columns_stage(node)
    return None


class FusedNode(Node):
    """Zip columns of multiple same-universe inputs into one table.

    All inputs share the same key set (enforced by the API layer), so a key's
    row parts arrive in the same epoch from each input; parts are cached until
    every input contributed (needed when inputs advance asymmetrically).
    """

    def __init__(self, graph, inputs, slices: list[dict[str, str]], name="Fuse"):
        # slices[i]: output_name -> input_i column name
        out_cols = [n for s in slices for n in s]
        super().__init__(graph, inputs, out_cols, name)
        self.slices = slices
        self._parts: list[TableState] = [TableState(i.column_names) for i in inputs]
        self._emitted: dict[int, tuple] = {}


    def reset(self):
        self._parts = [TableState(i.column_names) for i in self.inputs]
        self._emitted = {}

    def step(self, time, ins):
        changed: set[int] = set()
        for state, batch in zip(self._parts, ins):
            if batch is None:
                continue
            state.apply(batch)
            changed.update(int(k) for k in batch.keys)
        if not changed:
            return None
        rows: list[tuple[int, tuple, int]] = []
        for k in changed:
            parts = [st.get(k) for st in self._parts]
            old = self._emitted.get(k)
            if all(p is not None for p in parts):
                new_row = []
                for sl, part, inp in zip(self.slices, parts, self.inputs):
                    idx = {n: j for j, n in enumerate(inp.column_names)}
                    for out_name, src in sl.items():
                        new_row.append(part[idx[src]])
                new_row = tuple(new_row)
                if old is not None and not rows_equal(old, new_row):
                    rows.append((k, old, -1))
                    rows.append((k, new_row, 1))
                elif old is None:
                    rows.append((k, new_row, 1))
                self._emitted[k] = new_row
            else:
                if old is not None:
                    rows.append((k, old, -1))
                    del self._emitted[k]
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)


class ReindexNode(Node):
    """Re-key rows by a computed pointer expression (``with_id_from``)."""

    def __init__(self, graph, input_node, key_expr, name="Reindex"):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.key_expr = key_expr

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        env = EvalEnv(batch.cols, batch.keys, len(batch))
        ptrs = ExpressionEvaluator(env).eval(self.key_expr)
        new_keys = np.empty(len(batch), dtype=np.uint64)
        keep = np.ones(len(batch), dtype=bool)
        for i, p in enumerate(ptrs):
            if isinstance(p, Pointer):
                new_keys[i] = p.value
            else:
                keep[i] = False
                get_global_error_log().log(
                    f"reindex: non-pointer id {p!r}; row dropped"
                )
        out = Batch(new_keys, batch.cols, batch.diffs)
        if not keep.all():
            out = out.take(keep)
        return out


class ConcatNode(Node):
    """Union of disjoint-universe tables; duplicate keys are an error."""

    def __init__(self, graph, inputs, name="Concat"):
        super().__init__(graph, inputs, inputs[0].column_names, name)
        self._seen: list[MultisetState] = [MultisetState() for _ in inputs]


    def reset(self):
        self._seen = [MultisetState() for _ in self.inputs]

    def step(self, time, ins):
        outs = []
        for idx, batch in enumerate(ins):
            if batch is None:
                continue
            for k, _row, d in batch.rows():
                if d > 0:
                    for j, other in enumerate(self._seen):
                        if j != idx and int(k) in other:
                            raise DuplicateKeyError(
                                f"concat: key {k} present in multiple inputs "
                                "(universes must be disjoint)"
                            )
                self._seen[idx].apply_delta(int(k), d)
            # remap column names to output order
            mapping = dict(zip(self.inputs[idx].column_names, self.column_names))
            outs.append(batch.rename(mapping).select_cols(self.column_names))
        out = concat_batches(outs)
        return out


class UniverseOpNode(StatefulNode):
    """difference / intersect / restrict over key sets.

    Output rows come from input 0; membership predicate over the other inputs'
    key sets decides inclusion. Changes on any side produce add/remove deltas.
    """

    def __init__(self, graph, inputs, mode: str, name=None):
        super().__init__(graph, inputs, inputs[0].column_names, name or f"Universe[{mode}]")
        self.mode = mode
        self._emitted: dict[int, tuple] = {}


    def reset(self):
        super().reset()
        self._emitted = {}

    def _member(self, key: int) -> bool:
        others = self._in_states[1:]
        if self.mode == "difference":
            return not any(key in st.rows for st in others)
        if self.mode in ("intersect", "restrict"):
            return all(key in st.rows for st in others)
        raise ValueError(self.mode)

    def step(self, time, ins):
        affected: set[int] = set()
        for st, batch in zip(self._in_states, ins):
            if batch is None:
                continue
            st.apply(batch)
            affected.update(int(k) for k in batch.keys)
        if not affected:
            return None
        rows: list[tuple[int, tuple, int]] = []
        src = self._in_states[0]
        for k in affected:
            new = src.rows.get(k) if self._member(k) else None
            old = self._emitted.get(k)
            if rows_equal(old, new):
                continue
            if old is not None:
                rows.append((k, old, -1))
            if new is not None:
                rows.append((k, new, 1))
                self._emitted[k] = new
            else:
                self._emitted.pop(k, None)
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)


class UpdateRowsNode(StatefulNode):
    """``left.update_rows(right)``: right rows override left rows by key."""

    def __init__(self, graph, left, right, name="UpdateRows"):
        super().__init__(graph, [left, right], left.column_names, name)
        self._emitted: dict[int, tuple] = {}


    def reset(self):
        super().reset()
        self._emitted = {}

    def step(self, time, ins):
        affected: set[int] = set()
        for st, batch, inp in zip(self._in_states, ins, self.inputs):
            if batch is None:
                continue
            st.apply(batch)
            affected.update(int(k) for k in batch.keys)
        if not affected:
            return None
        left_st, right_st = self._in_states
        left_idx = {n: i for i, n in enumerate(self.inputs[0].column_names)}
        right_idx = {n: i for i, n in enumerate(self.inputs[1].column_names)}
        rows = []
        for k in affected:
            rrow = right_st.get(k)
            lrow = left_st.get(k)
            if rrow is not None:
                new = tuple(rrow[right_idx[n]] for n in self.column_names)
            elif lrow is not None:
                new = tuple(lrow[left_idx[n]] for n in self.column_names)
            else:
                new = None
            old = self._emitted.get(k)
            if rows_equal(old, new):
                continue
            if old is not None:
                rows.append((k, old, -1))
            if new is not None:
                rows.append((k, new, 1))
            if new is None:
                self._emitted.pop(k, None)
            else:
                self._emitted[k] = new
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)


class UpdateCellsNode(StatefulNode):
    """``left.update_cells(right)``: override selected columns where right
    has the key (right universe ⊆ left universe)."""

    def __init__(self, graph, left, right, update_columns: list[str], name="UpdateCells"):
        super().__init__(graph, [left, right], left.column_names, name)
        self.update_columns = set(update_columns)
        self._emitted: dict[int, tuple] = {}


    def reset(self):
        super().reset()
        self._emitted = {}

    def step(self, time, ins):
        affected: set[int] = set()
        for st, batch in zip(self._in_states, ins):
            if batch is None:
                continue
            st.apply(batch)
            affected.update(int(k) for k in batch.keys)
        if not affected:
            return None
        left_st, right_st = self._in_states
        left_idx = {n: i for i, n in enumerate(self.inputs[0].column_names)}
        right_idx = {n: i for i, n in enumerate(self.inputs[1].column_names)}
        rows = []
        for k in affected:
            lrow = left_st.get(k)
            rrow = right_st.get(k)
            if lrow is None:
                new = None
            else:
                new = tuple(
                    (
                        rrow[right_idx[n]]
                        if rrow is not None and n in self.update_columns and n in right_idx
                        else lrow[left_idx[n]]
                    )
                    for n in self.column_names
                )
            old = self._emitted.get(k)
            if rows_equal(old, new):
                continue
            if old is not None:
                rows.append((k, old, -1))
            if new is not None:
                rows.append((k, new, 1))
                self._emitted[k] = new
            else:
                self._emitted.pop(k, None)
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)


class IxNode(StatefulNode):
    """Pointer-based gather: for each row of ``keys_input`` holding a pointer
    column, fetch the referenced row of ``source``. ``optional`` pads missing
    targets with None (reference ``Table.ix``)."""

    def __init__(self, graph, keys_input, source, ptr_column: str, optional: bool, name="Ix"):
        super().__init__(graph, [keys_input, source], source.column_names, name)
        self.ptr_column = ptr_column
        self.optional = optional
        self._emitted: dict[int, tuple] = {}


    def reset(self):
        super().reset()
        self._emitted = {}

    def step(self, time, ins):
        keys_st, src_st = self._in_states
        affected: set[int] = set()  # keys of the LEFT (output universe)
        kb, sb = ins
        if kb is not None:
            keys_st.apply(kb)
            affected.update(int(k) for k in kb.keys)
        if sb is not None:
            src_st.apply(sb)
            # which left keys point at changed source keys?
            changed_targets = {int(k) for k in sb.keys}
            ptr_idx = self.inputs[0].column_names.index(self.ptr_column)
            for k, row in keys_st.rows.items():
                p = row[ptr_idx]
                if isinstance(p, Pointer) and p.value in changed_targets:
                    affected.add(k)
        if not affected:
            return None
        ptr_idx = self.inputs[0].column_names.index(self.ptr_column)
        rows = []
        for k in affected:
            lrow = keys_st.get(k)
            new = None
            if lrow is not None:
                p = lrow[ptr_idx]
                if isinstance(p, Pointer):
                    target = src_st.get(p.value)
                    if target is not None:
                        new = target
                    elif self.optional:
                        new = tuple(None for _ in self.column_names)
                    else:
                        get_global_error_log().log(
                            f"ix: missing key {p!r}"
                        )
                        new = tuple(ERROR for _ in self.column_names)
                elif p is None and self.optional:
                    new = tuple(None for _ in self.column_names)
                else:
                    new = tuple(ERROR for _ in self.column_names)
            old = self._emitted.get(k)
            if rows_equal(old, new):
                continue
            if old is not None:
                rows.append((k, old, -1))
            if new is not None:
                rows.append((k, new, 1))
                self._emitted[k] = new
            else:
                self._emitted.pop(k, None)
        if not rows:
            return None
        return Batch.from_rows(self.column_names, rows)


_FLATTEN_SALT = 0xF1A77E4


class FlattenNode(Node):
    """Explode an iterable column: one output row per element; new key =
    hash(key, index). Stateless — retraction of the input row retracts all
    derived rows identically."""

    def __init__(self, graph, input_node, flatten_column: str, name="Flatten",
                 origin_column: str | None = None):
        in_names = list(input_node.column_names)
        out_names = in_names + [origin_column] if origin_column else in_names
        super().__init__(graph, [input_node], out_names, name)
        self.flatten_column = flatten_column
        self.origin_column = origin_column
        self._in_names = in_names

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        names = self._in_names
        fcol = self.flatten_column
        idx = names.index(fcol)
        rows = []
        src_keys: list[int] = []
        positions: list[int] = []
        for k, row, d in batch.rows():
            value = row[idx]
            if value is ERROR:
                continue
            try:
                items = list(value)
            except TypeError:
                get_global_error_log().log(
                    f"flatten: value {value!r} is not iterable"
                )
                continue
            for j, item in enumerate(items):
                new_row = tuple(
                    item if i == idx else row[i] for i in range(len(row))
                )
                if self.origin_column:
                    new_row = new_row + (Pointer(int(k)),)
                rows.append((0, new_row, d))
                src_keys.append(k)
                positions.append(j)
        if not rows:
            return None
        # new key = hash_keys_with(key, salt of the element's position): one
        # vectorized pass a position, not a numpy call a row
        src = np.array(src_keys, dtype=np.uint64)
        pos = np.array(positions)
        new_keys = np.empty(len(rows), dtype=np.uint64)
        for j in np.unique(pos).tolist():
            at = pos == j
            new_keys[at] = hash_keys_with(src[at], _FLATTEN_SALT + j * 2 + 1)
        rows = [(int(key), row, d) for key, (_k, row, d) in zip(new_keys.tolist(), rows)]
        return Batch.from_rows(self.column_names, rows)
