"""``pw.temporal`` — event-time windows, temporal joins, behaviors.

Parity with reference ``python/pathway/stdlib/temporal/``:
windows (``tumbling``, ``sliding``, ``session``, ``intervals_over``) +
``windowby``; ``interval_join`` / ``asof_join`` / ``asof_now_join`` /
``window_join``; behaviors (``common_behavior``, ``exactly_once_behavior``)
lowered to the engine's buffer/forget/freeze operators.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.engine.operators import core as core_ops
from pathway_tpu_torch.engine.operators.instance_recompute import InstanceRecomputeNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import substitute
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.universe import Universe

__all__ = [
    "tumbling",
    "sliding",
    "session",
    "intervals_over",
    "windowby",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_right",
    "interval_join_outer",
    "asof_join",
    "asof_join_left",
    "asof_join_right",
    "asof_join_outer",
    "asof_now_join",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_right",
    "window_join_outer",
    "asof_now_join_inner",
    "asof_now_join_left",
    "common_behavior",
    "exactly_once_behavior",
    "apply_temporal_behavior",
    "Behavior",
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "Direction",
    "utils",
    "time_utils",
    "inactivity_detection",
    "utc_now",
]

from pathway_tpu_torch.stdlib.temporal import time_utils, utils  # noqa: E402  (cycle-safe tail imports)
from pathway_tpu_torch.stdlib.temporal.time_utils import (  # noqa: E402
    inactivity_detection,
    utc_now,
)


# ---------------------------------------------------------------------------
# behaviors


class Behavior:
    """Superclass of temporal behaviors (reference
    ``temporal_behavior.py:Behavior``)."""


@dataclass
class CommonBehavior(Behavior):
    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(delay=None, cutoff=None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Any = None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)


# ---------------------------------------------------------------------------
# window definitions


class Window:
    pass


@dataclass
class TumblingWindow(Window):
    duration: Any
    origin: Any = None

    def assign(self, t):
        origin = self.origin if self.origin is not None else _zero_like(t)
        idx = _floor_div(t - origin, self.duration)
        start = origin + idx * self.duration
        return [(start, start + self.duration)]


@dataclass
class SlidingWindow(Window):
    hop: Any
    duration: Any
    origin: Any = None

    def assign(self, t):
        origin = self.origin if self.origin is not None else _zero_like(t)
        out = []
        # windows [s, s+duration) with s = origin + k*hop containing t
        k_max = _floor_div(t - origin, self.hop)
        k = k_max
        while True:
            start = origin + k * self.hop
            if start + self.duration <= t:
                break
            out.append((start, start + self.duration))
            k -= 1
        return list(reversed(out))


@dataclass
class SessionWindow(Window):
    predicate: Callable | None = None
    max_gap: Any = None


def tumbling(duration=None, origin=None, **kwargs) -> TumblingWindow:
    return TumblingWindow(duration, origin)


def sliding(hop=None, duration=None, origin=None, ratio=None, **kwargs) -> SlidingWindow:
    # validate eagerly: a hopless/durationless window would otherwise fail
    # with an opaque TypeError deep inside window assignment (or silently
    # assign zero windows)
    if hop is None:
        raise ValueError("sliding() requires hop (optionally with ratio)")
    if duration is None and ratio is not None:
        duration = hop * ratio
    if duration is None:
        raise ValueError("sliding() requires duration or ratio")
    return SlidingWindow(hop, duration, origin)


def session(predicate=None, max_gap=None) -> SessionWindow:
    return SessionWindow(predicate, max_gap)


@dataclass
class IntervalsOverWindow(Window):
    at: Any
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True


def intervals_over(*, at, lower_bound, upper_bound, is_outer: bool = True):
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


def _pandas():
    """pandas when it is loaded, else None: a pandas value can only exist
    once pandas is imported, so int and float times never import it."""
    import sys

    return sys.modules.get("pandas")


def _zero_like(t):
    pd = _pandas()
    if pd is not None and isinstance(t, pd.Timestamp):
        ts = pd.Timestamp(0)
        return ts.tz_localize("UTC") if t.tzinfo is not None else ts
    if isinstance(t, float):
        return 0.0
    return 0


def _floor_div(delta, step) -> int:
    pd = _pandas()
    if pd is not None and isinstance(delta, pd.Timedelta):
        return int(delta.value // pd.Timedelta(step).value)
    return math.floor(delta / step)


# ---------------------------------------------------------------------------
# windowby


class WindowGroupedTable:
    """Result of windowby: reduce() aggregates per (instance, window)."""

    def __init__(self, table, time_expr, window: Window, behavior, instance):
        self._table = table
        self._time_expr = time_expr
        self._window = window
        self._behavior = behavior
        self._instance = instance

    def reduce(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table

        table = self._table
        window = self._window
        if isinstance(window, SessionWindow):
            tagged = _session_tag_table(
                table, self._time_expr, window, self._instance
            )
        else:
            win = window

            def windows_of(t):
                if t is None:
                    return ()
                return tuple(win.assign(t))

            with_windows = table.with_columns(
                __windows=expr_mod.apply_with_type(
                    windows_of, dt.ANY_TUPLE, self._time_expr
                ),
                __winst=(
                    self._instance
                    if self._instance is not None
                    else expr_mod.ColumnConstExpression(None)
                ),
            )
            flat = with_windows.flatten(with_windows["__windows"])
            tagged = flat.with_columns(
                _pw_window_start=flat["__windows"].get(0),
                _pw_window_end=flat["__windows"].get(1),
                _pw_window=expr_mod.make_tuple(
                    flat["__winst"],
                    flat["__windows"].get(0),
                    flat["__windows"].get(1),
                ),
            )
        # reference parity: the grouped view exposes the colocation key as
        # ``_pw_instance`` alongside the window columns
        inst_src = "__inst" if isinstance(window, SessionWindow) else "__winst"
        tagged = tagged.with_columns(_pw_instance=tagged[inst_src])
        # apply behavior: delay/cutoff on window end vs time column.
        # Lateness operators (freeze/forget) must see the RAW stream: their
        # watermark is derived from observed rows, and a buffer placed before
        # them would lag it — late rows released together with the buffered
        # batch would sneak past the cutoff (the reference's time_column
        # operators share the timely frontier, so order doesn't matter there).
        if self._behavior is not None and isinstance(self._behavior, CommonBehavior):
            b = self._behavior
            tagged = _ensure_time_col(tagged, self._time_expr)
            if b.cutoff is not None:
                if b.keep_results:
                    tagged = tagged._freeze(
                        tagged._pw_window_end + b.cutoff, tagged["__time_value"]
                    )
                else:
                    tagged = tagged._forget(
                        tagged._pw_window_end + b.cutoff, tagged["__time_value"]
                    )
            if b.delay is not None:
                tagged = tagged._buffer(
                    tagged._pw_window_start + b.delay, tagged["__time_value"]
                )
        elif self._behavior is not None and isinstance(self._behavior, ExactlyOnceBehavior):
            shift = self._behavior.shift
            tagged = _ensure_time_col(tagged, self._time_expr)
            thr = (
                tagged._pw_window_end + shift
                if shift is not None
                else tagged._pw_window_end
            )
            tagged = tagged._freeze(thr, tagged["__time_value"])
            tagged = tagged._buffer(thr, tagged["__time_value"])

        grouped = tagged.groupby(
            tagged._pw_window,
            sort_by=None,
        )
        # substitute special refs in reduce args (_window_meta_rewrite maps
        # the _pw_* meta columns to any(...) reducers)
        new_kwargs = {}
        from pathway_tpu_torch.internals import reducers as red_mod

        instance_name = (
            self._instance.name
            if isinstance(self._instance, ColumnReference)
            else None
        )
        for name, e in _named_reduce_args(args, kwargs).items():
            e = expr_mod.smart_coerce(e)
            e = substitute(e, {thisclass.this: tagged})
            new_kwargs[name] = _window_meta_rewrite(e, tagged, instance_name)
        result = grouped.reduce(**new_kwargs)
        return result


def _named_reduce_args(args, kwargs) -> dict:
    """Positional reduce args (column references, e.g. the window-key
    columns) project under their own names, like ``Table.reduce``."""
    named = {}
    for a in args:
        if not isinstance(a, ColumnReference):
            raise ValueError(
                "positional windowby(...).reduce arguments must be column "
                "references; use keyword arguments for computed values"
            )
        if a.name in named or a.name in kwargs:
            raise ValueError(f"duplicate reduce column {a.name!r}")
        named[a.name] = a
    named.update(kwargs)
    return named


def _window_meta_rewrite(e, tagged, instance_name=None):
    """Map refs that are constant within a window group — the _pw_window*
    meta columns and the instance column — to `any(...)` reducers."""
    from pathway_tpu_torch.internals import reducers as red_mod

    if isinstance(e, ColumnReference):
        constant_cols = (
            "_pw_window_start", "_pw_window_end", "_pw_window", "_pw_instance",
        )
        if e.name in constant_cols or (
            instance_name is not None and e.name == instance_name
        ):
            return red_mod.any(tagged[e.name])
        return e
    import copy

    e = copy.copy(e)
    for attr in ("_left", "_right", "_expr", "_if", "_then", "_else"):
        if hasattr(e, attr):
            v = getattr(e, attr)
            if isinstance(v, ColumnExpression):
                setattr(e, attr, _window_meta_rewrite(v, tagged))
    if hasattr(e, "_args") and not isinstance(e, expr_mod.ReducerExpression):
        e._args = tuple(
            _window_meta_rewrite(a, tagged) if isinstance(a, ColumnExpression) else a
            for a in e._args
        )
    return e


def _ensure_time_col(tagged, time_expr):
    if "__time_value" in tagged.column_names():
        return tagged
    if isinstance(time_expr, ColumnReference) and time_expr.name in tagged.column_names():
        return tagged.with_columns(__time_value=tagged[time_expr.name])
    return tagged.with_columns(__time_value=tagged._pw_window_end)


def _merge_sessions(entries, time_of, predicate, max_gap):
    """THE session-merge rule (shared by windowby sessions and session
    window joins so the two can never drift): entries are time-sorted;
    adjacent entries merge when ``predicate(prev_t, next_t)`` (or
    ``next_t - prev_t <= max_gap``)."""
    sessions: list[list] = [[entries[0]]]
    for prev, nxt in zip(entries, entries[1:]):
        pt, nt = time_of(prev), time_of(nxt)
        if predicate is not None:
            merge = predicate(pt, nt)
        else:
            merge = (nt - pt) <= max_gap
        if merge:
            sessions[-1].append(nxt)
        else:
            sessions.append([nxt])
    return sessions


def _session_tag_table(table, time_expr, window: SessionWindow, instance):
    """Tag rows with merged session windows per instance."""
    from pathway_tpu_torch.internals.table import Table, _prepare_env

    exprs = {
        "__t": time_expr,
        "__inst": (
            instance if instance is not None else expr_mod.ColumnConstExpression(None)
        ),
        **{n: ColumnReference(table, n) for n in table.column_names()},
    }
    env, rw = _prepare_env(table, exprs)
    prep = core_ops.RowwiseNode(G.engine_graph, env, rw)
    in_cols = prep.column_names
    ti = in_cols.index("__t")
    max_gap = window.max_gap
    predicate = window.predicate
    out_cols = list(in_cols) + ["_pw_window_start", "_pw_window_end", "_pw_window"]

    def compute(inst, rows):
        entries = sorted(rows.items(), key=lambda kv: (kv[1][ti], kv[0]))
        out: dict[int, tuple] = {}
        if not entries:
            return out
        sessions = _merge_sessions(
            entries, lambda e: e[1][ti], predicate, max_gap
        )
        for sess in sessions:
            start = sess[0][1][ti]
            end = sess[-1][1][ti]
            wid = (inst, start, end)
            for key, row in sess:
                out[key] = tuple(row) + (start, end, wid)
        return out

    node = InstanceRecomputeNode(
        G.engine_graph,
        [prep],
        ["__inst"],
        out_cols,
        lambda inst, rows: compute(inst, rows),
        name="SessionWindows",
    )
    defs = dict(table._schema.__columns__)
    schema = schema_mod.schema_builder_from_definitions(
        {
            **{
                n: schema_mod.ColumnDefinition(
                    dtype=(
                        defs[n].dtype if n in defs else dt.ANY
                    ),
                    name=n,
                )
                for n in in_cols
            },
            "_pw_window_start": schema_mod.ColumnDefinition(dtype=dt.ANY),
            "_pw_window_end": schema_mod.ColumnDefinition(dtype=dt.ANY),
            "_pw_window": schema_mod.ColumnDefinition(dtype=dt.ANY),
        }
    )
    return Table(node, schema, Universe())


def windowby(table, time_expr, *, window: Window, behavior=None, instance=None, **kwargs):
    time_expr = substitute(time_expr, {thisclass.this: table})
    if instance is not None:
        instance = substitute(
            expr_mod.smart_coerce(instance), {thisclass.this: table}
        )
    if isinstance(window, IntervalsOverWindow):
        return _intervals_over_grouped(table, time_expr, window, instance)
    return WindowGroupedTable(table, time_expr, window, behavior, instance)


def _intervals_over_grouped(table, time_expr, window: IntervalsOverWindow, instance):
    """intervals_over: for each value in `at`, aggregate rows with time in
    [at+lower, at+upper]."""

    class _IntervalsGrouped:
        def reduce(self_inner, *args, **kwargs):
            from pathway_tpu_torch.internals.table import Table, _prepare_env

            at_col = window.at
            at_table = at_col.table if isinstance(at_col, ColumnReference) else table
            # left: data rows; right: at-points; both keyed by shared instance
            exprs = {
                "__t": time_expr,
                "__inst": (
                    instance
                    if instance is not None
                    else expr_mod.ColumnConstExpression(None)
                ),
                **{n: ColumnReference(table, n) for n in table.column_names()},
            }
            env, rw = _prepare_env(table, exprs)
            data_prep = core_ops.RowwiseNode(G.engine_graph, env, rw)
            at_exprs = {
                "__at": at_col,
                "__inst": expr_mod.ColumnConstExpression(None),
            }
            env2, rw2 = _prepare_env(at_table, at_exprs)
            at_prep = core_ops.RowwiseNode(G.engine_graph, env2, rw2)
            in_cols = data_prep.column_names
            ti = in_cols.index("__t")
            lower, upper = window.lower_bound, window.upper_bound
            out_cols = list(in_cols) + ["_pw_window", "_pw_window_location"]

            def compute(inst, data_rows, at_rows):
                out: dict[int, tuple] = {}
                ats = {row[0] for row in at_rows.values()}
                for at in ats:
                    lo, hi = at + lower, at + upper
                    wid = (inst, at)
                    members = [
                        (k, row)
                        for k, row in data_rows.items()
                        if lo <= row[ti] <= hi
                    ]
                    if not members and not window.is_outer:
                        continue
                    if not members:
                        k = hash_values(inst, at, "empty")
                        out[k] = tuple(
                            None for _ in in_cols
                        ) + (wid, at)
                        continue
                    for k, row in members:
                        out[hash_values(k, at)] = tuple(row) + (wid, at)
                return out

            node = InstanceRecomputeNode(
                G.engine_graph,
                [data_prep, at_prep],
                ["__inst", "__inst"],
                out_cols,
                compute,
                name="IntervalsOver",
            )
            defs = dict(table._schema.__columns__)
            schema = schema_mod.schema_builder_from_definitions(
                {
                    **{
                        n: schema_mod.ColumnDefinition(
                            dtype=(defs[n].dtype if n in defs else dt.ANY), name=n
                        )
                        for n in in_cols
                    },
                    "_pw_window": schema_mod.ColumnDefinition(dtype=dt.ANY),
                    "_pw_window_location": schema_mod.ColumnDefinition(dtype=dt.ANY),
                }
            )
            tagged = Table(node, schema, Universe())
            grouped = tagged.groupby(tagged._pw_window)
            new_kwargs = {}
            for name, e in _named_reduce_args(args, kwargs).items():
                e = expr_mod.smart_coerce(e)
                e = substitute(e, {thisclass.this: tagged})
                new_kwargs[name] = _window_meta_rewrite_io(e, tagged)
            return grouped.reduce(**new_kwargs)

    return _IntervalsGrouped()


def _window_meta_rewrite_io(e, tagged):
    from pathway_tpu_torch.internals import reducers as red_mod

    if isinstance(e, ColumnReference):
        if e.name in ("_pw_window_location", "_pw_window"):
            return red_mod.any(tagged[e.name])
        return e
    import copy

    e = copy.copy(e)
    if hasattr(e, "_args") and not isinstance(e, expr_mod.ReducerExpression):
        e._args = tuple(
            _window_meta_rewrite_io(a, tagged)
            if isinstance(a, ColumnExpression)
            else a
            for a in e._args
        )
    return e


# ---------------------------------------------------------------------------
# temporal joins


@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    return Interval(lower_bound, upper_bound)


class _Direction:
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


def _binary_temporal(
    left_table,
    right_table,
    t_left,
    t_right,
    on,
    how: str,
    compute_factory,
    extra_out_cols: list[str],
    name: str,
):
    """Shared plumbing: prep both sides with (__t, __inst, columns), run an
    InstanceRecomputeNode, expose a JoinResult-like select surface."""
    from pathway_tpu_torch.internals.table import Table, _prepare_env

    t_left = substitute(t_left, {thisclass.this: left_table, thisclass.left: left_table})
    t_right = substitute(t_right, {thisclass.this: right_table, thisclass.right: right_table})
    l_on_exprs = []
    r_on_exprs = []
    for cond in on:
        if not isinstance(cond, expr_mod.ColumnBinaryOpExpression) or cond._operator != "==":
            raise ValueError("temporal join conditions must be equality")
        l_on_exprs.append(
            substitute(cond._left, {thisclass.left: left_table, thisclass.this: left_table})
        )
        r_on_exprs.append(
            substitute(cond._right, {thisclass.right: right_table, thisclass.this: right_table})
        )

    def make_inst(exprs):
        if not exprs:
            return expr_mod.ColumnConstExpression(None)
        if len(exprs) == 1:
            return exprs[0]
        return expr_mod.make_tuple(*exprs)

    lexprs = {
        "__t": t_left,
        "__inst": make_inst(l_on_exprs),
        "__id": ColumnReference(left_table, "id"),
        **{f"__l_{n}": ColumnReference(left_table, n) for n in left_table.column_names()},
    }
    env, rw = _prepare_env(left_table, lexprs)
    lprep = core_ops.RowwiseNode(G.engine_graph, env, rw)
    rexprs = {
        "__t": t_right,
        "__inst": make_inst(r_on_exprs),
        "__id": ColumnReference(right_table, "id"),
        **{f"__r_{n}": ColumnReference(right_table, n) for n in right_table.column_names()},
    }
    env, rw = _prepare_env(right_table, rexprs)
    rprep = core_ops.RowwiseNode(G.engine_graph, env, rw)

    l_cols = lprep.column_names
    r_cols = rprep.column_names
    out_cols = (
        [c for c in l_cols if c.startswith("__l_")]
        + ["__l_id", "__l_t"]
        + [c for c in r_cols if c.startswith("__r_")]
        + ["__r_id", "__r_t"]
        + extra_out_cols
    )
    compute = compute_factory(l_cols, r_cols, out_cols)
    node = InstanceRecomputeNode(
        G.engine_graph, [lprep, rprep], ["__inst", "__inst"], out_cols, compute, name=name
    )
    return _TemporalJoinResult(node, left_table, right_table, how)


class _TemporalJoinResult:
    def __init__(self, node, left_table, right_table, how):
        self._node = node
        self._left = left_table
        self._right = right_table
        self._how = how

    def select(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table

        exprs: dict[str, ColumnExpression] = {}
        for a in args:
            if isinstance(a, thisclass._StarMarker):
                src = a.placeholder
                if src is thisclass.left:
                    for n in self._left.column_names():
                        exprs[n] = ColumnReference(thisclass.left, n)
                elif src is thisclass.right:
                    for n in self._right.column_names():
                        exprs[n] = ColumnReference(thisclass.right, n)
                else:
                    for n in self._left.column_names():
                        exprs[n] = ColumnReference(thisclass.left, n)
                    for n in self._right.column_names():
                        if n not in exprs:
                            exprs[n] = ColumnReference(thisclass.right, n)
            elif isinstance(a, ColumnReference):
                exprs[a.name] = a
            else:
                raise ValueError(f"bad select argument {a!r}")
        for name, e in kwargs.items():
            exprs[name] = expr_mod.smart_coerce(e)

        def rw(e):
            import copy

            if isinstance(e, ColumnReference):
                t = e._table
                if t is thisclass.left or t is self._left:
                    return ColumnReference(
                        None, "__l_id" if e._name == "id" else f"__l_{e._name}"
                    )
                if t is thisclass.right or t is self._right:
                    return ColumnReference(
                        None, "__r_id" if e._name == "id" else f"__r_{e._name}"
                    )
                if t is thisclass.this:
                    if e._name in self._left.column_names():
                        return ColumnReference(None, f"__l_{e._name}")
                    return ColumnReference(None, f"__r_{e._name}")
                return e
            e = copy.copy(e)
            for attr in ("_left", "_right", "_expr", "_if", "_then", "_else",
                         "_val", "_obj", "_index", "_default", "_replacement"):
                if hasattr(e, attr):
                    v = getattr(e, attr)
                    if isinstance(v, ColumnExpression):
                        setattr(e, attr, rw(v))
            if hasattr(e, "_args"):
                e._args = tuple(
                    rw(a) if isinstance(a, ColumnExpression) else a for a in e._args
                )
            return e

        rewritten = {n: rw(e) for n, e in exprs.items()}
        out = core_ops.RowwiseNode(G.engine_graph, self._node, rewritten)
        defs = {}
        for name, orig in exprs.items():
            dtype = dt.ANY
            if isinstance(orig, ColumnReference):
                t = orig._table
                src = None
                if t is thisclass.left or t is self._left:
                    src = self._left
                elif t is thisclass.right or t is self._right:
                    src = self._right
                elif t is thisclass.this:
                    src = (
                        self._left
                        if orig._name in self._left.column_names()
                        else self._right
                    )
                if src is not None and orig._name in src._schema.__columns__:
                    dtype = src._schema.__columns__[orig._name].dtype
                    if self._how != "inner":
                        dtype = dt.Optional(dtype)
            defs[name] = schema_mod.ColumnDefinition(dtype=dtype, name=name)
        schema = schema_mod.schema_builder_from_definitions(defs)
        return Table(out, schema, Universe())


def _null_row(cols, prefix):
    return tuple(None for c in cols if c.startswith(prefix))


def asof_join(
    left_table,
    right_table,
    t_left,
    t_right,
    *on,
    how="inner",
    defaults=None,
    direction="backward",
):
    """For each left row, match the right row closest in time (per direction).

    Reference: ``stdlib/temporal/_asof_join.py:479``.
    """
    if hasattr(how, "value"):
        how = how.value

    def factory(l_cols, r_cols, out_cols):
        lti = l_cols.index("__t")
        lid = l_cols.index("__id")
        rti = r_cols.index("__t")
        rid = r_cols.index("__id")
        l_data = [i for i, c in enumerate(l_cols) if c.startswith("__l_")]
        r_data = [i for i, c in enumerate(r_cols) if c.startswith("__r_")]

        def compute(inst, lrows, rrows):
            out: dict[int, tuple] = {}
            rsorted = sorted(rrows.values(), key=lambda r: (r[rti], r[rid]))
            import bisect

            rtimes = [r[rti] for r in rsorted]
            matched_right = set()
            for lk, lrow in lrows.items():
                t = lrow[lti]
                match = None
                if direction == "backward":
                    i = bisect.bisect_right(rtimes, t) - 1
                    if i >= 0:
                        match = rsorted[i]
                elif direction == "forward":
                    i = bisect.bisect_left(rtimes, t)
                    if i < len(rsorted):
                        match = rsorted[i]
                else:  # nearest
                    i = bisect.bisect_right(rtimes, t) - 1
                    cand = []
                    if i >= 0:
                        cand.append(rsorted[i])
                    if i + 1 < len(rsorted):
                        cand.append(rsorted[i + 1])
                    if cand:
                        match = min(cand, key=lambda r: abs(r[rti] - t))
                if match is None and how == "inner":
                    continue
                lpart = tuple(lrow[i] for i in l_data) + (lrow[lid], lrow[lti])
                if match is not None:
                    matched_right.add(match[rid].value if hasattr(match[rid], "value") else match[rid])
                    rpart = tuple(match[i] for i in r_data) + (
                        match[rid],
                        match[rti],
                    )
                else:
                    rpart = tuple(None for _ in r_data) + (None, None)
                key = lrow[lid].value if hasattr(lrow[lid], "value") else lk
                out[key] = lpart + rpart
            if how in ("right", "outer"):
                for rk, rrow in rrows.items():
                    rid_v = rrow[rid].value if hasattr(rrow[rid], "value") else rk
                    if rid_v in matched_right:
                        continue
                    lpart = tuple(None for _ in l_data) + (None, None)
                    rpart = tuple(rrow[i] for i in r_data) + (rrow[rid], rrow[rti])
                    out[rid_v] = lpart + rpart
            return out

        return compute

    return _binary_temporal(
        left_table, right_table, t_left, t_right, on, how, factory, [], "AsofJoin"
    )


def asof_join_left(l, r, tl, tr, *on, **kw):
    return asof_join(l, r, tl, tr, *on, how="left", **kw)


def asof_join_right(l, r, tl, tr, *on, **kw):
    return asof_join(l, r, tl, tr, *on, how="right", **kw)


def asof_join_outer(l, r, tl, tr, *on, **kw):
    return asof_join(l, r, tl, tr, *on, how="outer", **kw)


def interval_join(
    left_table, right_table, t_left, t_right, interval_: Interval, *on, how="inner"
):
    """Pairs (l, r) with t_right - t_left in [lower, upper] (reference
    ``_interval_join.py:577``)."""
    if hasattr(how, "value"):
        how = how.value
    lower, upper = interval_.lower_bound, interval_.upper_bound

    def factory(l_cols, r_cols, out_cols):
        lti = l_cols.index("__t")
        lid = l_cols.index("__id")
        rti = r_cols.index("__t")
        rid = r_cols.index("__id")
        l_data = [i for i, c in enumerate(l_cols) if c.startswith("__l_")]
        r_data = [i for i, c in enumerate(r_cols) if c.startswith("__r_")]

        def compute(inst, lrows, rrows):
            out: dict[int, tuple] = {}
            matched_l = set()
            matched_r = set()
            for lk, lrow in lrows.items():
                for rk, rrow in rrows.items():
                    delta = rrow[rti] - lrow[lti]
                    if lower <= delta <= upper:
                        matched_l.add(lk)
                        matched_r.add(rk)
                        key = hash_values(lk, rk)
                        out[key] = (
                            tuple(lrow[i] for i in l_data)
                            + (lrow[lid], lrow[lti])
                            + tuple(rrow[i] for i in r_data)
                            + (rrow[rid], rrow[rti])
                        )
            if how in ("left", "outer"):
                for lk, lrow in lrows.items():
                    if lk not in matched_l:
                        out[hash_values(lk, 0)] = (
                            tuple(lrow[i] for i in l_data)
                            + (lrow[lid], lrow[lti])
                            + tuple(None for _ in r_data)
                            + (None, None)
                        )
            if how in ("right", "outer"):
                for rk, rrow in rrows.items():
                    if rk not in matched_r:
                        out[hash_values(0, rk)] = (
                            tuple(None for _ in l_data)
                            + (None, None)
                            + tuple(rrow[i] for i in r_data)
                            + (rrow[rid], rrow[rti])
                        )
            return out

        return compute

    return _binary_temporal(
        left_table, right_table, t_left, t_right, on, how, factory, [], "IntervalJoin"
    )


def interval_join_inner(l, r, tl, tr, i, *on, **kw):
    return interval_join(l, r, tl, tr, i, *on, how="inner", **kw)


def interval_join_left(l, r, tl, tr, i, *on, **kw):
    return interval_join(l, r, tl, tr, i, *on, how="left", **kw)


def interval_join_right(l, r, tl, tr, i, *on, **kw):
    return interval_join(l, r, tl, tr, i, *on, how="right", **kw)


def interval_join_outer(l, r, tl, tr, i, *on, **kw):
    return interval_join(l, r, tl, tr, i, *on, how="outer", **kw)


def window_join(left_table, right_table, t_left, t_right, window: Window, *on, how="inner"):
    """Pairs of rows falling into the same window (reference
    ``_window_join.py``)."""
    if hasattr(how, "value"):
        how = how.value

    def factory(l_cols, r_cols, out_cols):
        lti = l_cols.index("__t")
        lid = l_cols.index("__id")
        rti = r_cols.index("__t")
        rid = r_cols.index("__id")
        l_data = [i for i, c in enumerate(l_cols) if c.startswith("__l_")]
        r_data = [i for i, c in enumerate(r_cols) if c.startswith("__r_")]

        def emit_pairs(out, ls, rs, w):
            """Shared pairing per window id ``w`` with outer padding."""
            if ls and rs:
                for lk, lrow in ls:
                    for rk, rrow in rs:
                        out[hash_values(lk, rk, w)] = (
                            tuple(lrow[i] for i in l_data)
                            + (lrow[lid], lrow[lti])
                            + tuple(rrow[i] for i in r_data)
                            + (rrow[rid], rrow[rti])
                        )
            elif ls and how in ("left", "outer"):
                for lk, lrow in ls:
                    out[hash_values(lk, 0, w)] = (
                        tuple(lrow[i] for i in l_data)
                        + (lrow[lid], lrow[lti])
                        + tuple(None for _ in r_data)
                        + (None, None)
                    )
            elif rs and how in ("right", "outer"):
                for rk, rrow in rs:
                    out[hash_values(0, rk, w)] = (
                        tuple(None for _ in l_data)
                        + (None, None)
                        + tuple(rrow[i] for i in r_data)
                        + (rrow[rid], rrow[rti])
                    )

        def compute_session(inst, lrows, rrows):
            # sessions merge over the UNION of both sides' times (reference
            # ``_window_join.py`` session mode): a session window id cannot
            # be assigned per row, so merge here and pair within sessions
            entries = sorted(
                [("l", k, row, row[lti]) for k, row in lrows.items()]
                + [("r", k, row, row[rti]) for k, row in rrows.items()],
                key=lambda e: (e[3], e[0], e[1]),
            )
            out: dict[int, tuple] = {}
            if not entries:
                return out
            sessions = _merge_sessions(
                entries, lambda e: e[3], window.predicate, window.max_gap
            )
            for sess in sessions:
                w = (sess[0][3], sess[-1][3])
                ls = [(k, row) for side, k, row, _t in sess if side == "l"]
                rs = [(k, row) for side, k, row, _t in sess if side == "r"]
                emit_pairs(out, ls, rs, w)
            return out

        def compute(inst, lrows, rrows):
            from collections import defaultdict as dd

            out: dict[int, tuple] = {}
            l_by_win = dd(list)
            r_by_win = dd(list)
            for lk, lrow in lrows.items():
                for w in window.assign(lrow[lti]):
                    l_by_win[w].append((lk, lrow))
            for rk, rrow in rrows.items():
                for w in window.assign(rrow[rti]):
                    r_by_win[w].append((rk, rrow))
            for w in set(l_by_win) | set(r_by_win):
                emit_pairs(out, l_by_win.get(w, []), r_by_win.get(w, []), w)
            return out

        return compute_session if isinstance(window, SessionWindow) else compute

    return _binary_temporal(
        left_table, right_table, t_left, t_right, on, how, factory, [], "WindowJoin"
    )


def asof_now_join(left_table, right_table, *on, id=None, how="inner"):
    """Join where left rows are matched against the right table *as of their
    arrival* — left updates don't retrigger (reference ``_asof_now_join.py``).

    Engine note: with the epoch model, new left rows see the right state at
    their epoch; subsequent right updates do not update old results.
    """
    from pathway_tpu_torch.engine.operators.asof_now import AsofNowJoinNode
    from pathway_tpu_torch.internals.table import _prepare_env
    from pathway_tpu_torch.internals.table import Table

    l_on, r_on = [], []
    for cond in on:
        if not isinstance(cond, expr_mod.ColumnBinaryOpExpression) or cond._operator != "==":
            raise ValueError("join conditions must be equality")
        l_on.append(
            substitute(cond._left, {thisclass.left: left_table, thisclass.this: left_table})
        )
        r_on.append(
            substitute(cond._right, {thisclass.right: right_table, thisclass.this: right_table})
        )
    lexprs = {f"__c_{n}": ColumnReference(left_table, n) for n in left_table.column_names()}
    lexprs["__id"] = ColumnReference(left_table, "id")
    for i, e in enumerate(l_on):
        lexprs[f"__jk{i}"] = e
    env, rw = _prepare_env(left_table, lexprs)
    lprep = core_ops.RowwiseNode(G.engine_graph, env, rw)
    rexprs = {f"__c_{n}": ColumnReference(right_table, n) for n in right_table.column_names()}
    rexprs["__id"] = ColumnReference(right_table, "id")
    for i, e in enumerate(r_on):
        rexprs[f"__jk{i}"] = e
    env, rw = _prepare_env(right_table, rexprs)
    rprep = core_ops.RowwiseNode(G.engine_graph, env, rw)
    from pathway_tpu_torch.internals.joins import JoinResult

    jr = JoinResult.__new__(JoinResult)
    jr._left = left_table
    jr._right = right_table
    jr._how = how
    jr._id = id

    jk_cols = [f"__jk{i}" for i in range(len(l_on))]
    output_spec = (
        [(f"__l_{n}", "left", f"__c_{n}") for n in left_table.column_names()]
        + [("__l_id", "left", "__id")]
        + [(f"__r_{n}", "right", f"__c_{n}") for n in right_table.column_names()]
        + [("__r_id", "right", "__id")]
    )
    node = AsofNowJoinNode(
        G.engine_graph,
        lprep,
        rprep,
        jk_cols,
        jk_cols,
        how,
        output_spec,
        key_mode="left",
    )
    jr._build = lambda: node  # reuse JoinResult.select over this node
    return jr


Direction = _Direction


def apply_temporal_behavior(table, behavior):
    """Lower a ``CommonBehavior`` onto a table carrying a ``_pw_time``
    column: delay buffers, cutoff freezes+forgets (reference
    ``temporal_behavior.py:101``)."""
    if behavior is not None:
        if not isinstance(behavior, CommonBehavior):
            raise TypeError(
                "apply_temporal_behavior expects a CommonBehavior (use "
                "common_behavior(...)); exactly_once_behavior applies only "
                "inside windowby"
            )
        time_col = table["_pw_time"]
        if behavior.delay is not None:
            table = table._buffer(time_col + behavior.delay, time_col)
        if behavior.cutoff is not None:
            # same lowering as windowby: freeze drops late arrivals; results
            # are retracted past the cutoff only when keep_results is False
            threshold = table["_pw_time"] + behavior.cutoff
            table = table._freeze(threshold, table["_pw_time"])
            if not behavior.keep_results:
                table = table._forget(threshold, table["_pw_time"])
    return table


def window_join_inner(left_table, right_table, t_left, t_right, window, *on):
    return window_join(left_table, right_table, t_left, t_right, window, *on, how="inner")


def window_join_left(left_table, right_table, t_left, t_right, window, *on):
    return window_join(left_table, right_table, t_left, t_right, window, *on, how="left")


def window_join_right(left_table, right_table, t_left, t_right, window, *on):
    return window_join(left_table, right_table, t_left, t_right, window, *on, how="right")


def window_join_outer(left_table, right_table, t_left, t_right, window, *on):
    return window_join(left_table, right_table, t_left, t_right, window, *on, how="outer")


def asof_now_join_inner(left_table, right_table, *on, id=None):  # noqa: A002
    return asof_now_join(left_table, right_table, *on, id=id, how="inner")


def asof_now_join_left(left_table, right_table, *on, id=None):  # noqa: A002
    return asof_now_join(left_table, right_table, *on, id=id, how="left")


# reference result-class names (our temporal joins expose the same select
# surface through _binary_temporal's JoinResult-like object)
class AsofJoinResult:  # noqa: D401 — name parity marker
    """Alias target for reference ``_asof_join.py:AsofJoinResult``."""


class AsofNowJoinResult:
    """Alias target for reference ``_asof_now_join.py:AsofNowJoinResult``."""


class IntervalJoinResult:
    """Alias target for reference ``_interval_join.py:IntervalJoinResult``."""


class WindowJoinResult:
    """Alias target for reference ``_window_join.py:WindowJoinResult``."""
