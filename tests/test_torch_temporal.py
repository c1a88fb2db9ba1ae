"""The port's temporal operators held against the JAX package's, program
by program: the same tables go through both packages' ``pw.temporal``
(windows with their behaviours, the asof, interval, window and asof-now
joins), ``Table.diff`` / ``interpolate`` and ``deduplicate``; the final
tables (row ids and values) and the subscribe update streams (row id,
row, time, is_addition; in order) must be equal.

The cases are every test of ``tests/test_temporal.py`` and
``tests/test_temporal_edges.py``, the temporal cases of
``tests/test_streaming_semantics.py`` and, over their seeds, of
``tests/test_incremental_equivalence.py``; the engine nodes (Buffer,
Forget, Freeze, InstanceRecompute, AsofNowJoin) stepped with the same
batches on both packages; a datetime / ``Duration`` window; an int-timed
program in a subprocess without pandas; the public names of
``pw.temporal``, ``pw.ordered`` and ``pw.statistical``; and the event-time
windowed embed stream of ``chip_smoke.py`` phase 19 at a small size."""

import datetime
import json
import os
import random
import subprocess
import sys
import textwrap
import threading
import time
from importlib import import_module

import numpy as np
import pytest

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu.engine import batch as j_batch
from pathway_tpu.engine import graph as j_graph
from pathway_tpu.engine.operators import asof_now as j_asof_now
from pathway_tpu.engine.operators import instance_recompute as j_ir
from pathway_tpu.engine.operators import join as j_join
from pathway_tpu.engine.operators import temporal as j_temporal
from pathway_tpu.engine.value import ERROR as J_ERROR
from pathway_tpu_torch.engine import batch as t_batch
from pathway_tpu_torch.engine import graph as t_graph
from pathway_tpu_torch.engine.operators import asof_now as t_asof_now
from pathway_tpu_torch.engine.operators import instance_recompute as t_ir
from pathway_tpu_torch.engine.operators import temporal as t_temporal
from pathway_tpu_torch.engine.value import ERROR as T_ERROR
from tests.torch_engine import PACKAGES, PW, canon, final_state, update_stream


def _md(pw, *texts):
    return [pw.debug.table_from_markdown(t) for t in texts]


def _run(pkg, build):
    pw = PW[pkg]
    pw.clear_graph()
    final = final_state(pkg, build(pw))
    pw.clear_graph()
    stream = update_stream(pkg, build(pw))
    pw.clear_graph()
    return final, stream


def _both(build):
    """(JAX's, the port's) final table and update stream of ``build``."""
    return tuple(_run(pkg, build) for pkg in PACKAGES)


def _values(final):
    """The final table's rows, without their ids, sorted."""
    (rows, _cols) = final
    return sorted(rows.values(), key=repr)


# ------------------------------------------------------------ table programs
# each builds one program against a package's ``pw`` and returns its table

TV = """
    t  | v
    1  | 10
    2  | 1
    5  | 3
    6  | 2
    11 | 4
    """


def _window(md, window, behavior=None, instance=None, **reduce):
    """``windowby(t.t, ...).reduce(**reduce)`` over the table ``md``;
    ``window`` and ``behavior`` take the package's ``pw.temporal``,
    ``reduce`` values take its ``pw``."""
    def build(pw):
        (t,) = _md(pw, md)
        kw = {} if instance is None else {"instance": t[instance]}
        grouped = t.windowby(t.t, window=window(pw.temporal),
                             behavior=behavior(pw.temporal) if behavior else None, **kw)
        return grouped.reduce(**{n: f(pw) for n, f in reduce.items()})
    return build


def _sum_v(pw):
    return pw.reducers.sum(pw.this.v)


def _start(pw):
    return pw.this._pw_window_start


def _count(pw):
    return pw.reducers.count()


def p_windowby_instance_column(pw):
    (t,) = _md(pw, """
        t | g | v
        1 | a | 1
        2 | a | 2
        1 | b | 4
        """)
    return t.windowby(t.t, window=pw.temporal.tumbling(duration=5), instance=t.g).reduce(
        pw.this._pw_instance, s=pw.reducers.sum(pw.this.v))


def p_windowby_instance_positional(pw):
    (t,) = _md(pw, """
        t  | v | g
        1  | 10 | a
        2  | 1 | a
        5  | 3 | b
        6  | 2 | a
        11 | 4 | b
        """)
    return t.windowby(t.t, window=pw.temporal.tumbling(duration=5), instance=t.g).reduce(
        pw.this.g, start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))


def _join(kind, md_left, md_right, *args, how=None, on=False, select=None, **kw):
    """``pw.temporal.<kind>(t1, t2, t1.t, t2.t, *args)`` (args take the
    package's ``pw.temporal``), then ``select``."""
    def build(pw):
        t1, t2 = _md(pw, md_left, md_right)
        cond = (t1.k == t2.k,) if on else ()
        extra = {} if how is None else {"how": how}
        res = getattr(pw.temporal, kind)(t1, t2, t1.t, t2.t,
                                         *[a(pw.temporal) for a in args], *cond, **extra, **kw)
        if select is not None:
            return select(pw, res)
        return res.select(pw.left.a, pw.right.b)
    return build


def _interval(lo, hi):
    return lambda temporal: temporal.interval(lo, hi)


def _tumbling5(temporal):
    return temporal.tumbling(duration=5)


def p_asof_now_join(pw):
    t1, t2 = _md(pw, """
        k | a | __time__
        x | 1 | 4
        """, """
        k | b | __time__
        x | 10 | 2
        x | 20 | 6
        """)
    return pw.temporal.asof_now_join(t1, t2, t1.k == t2.k).select(pw.left.a, pw.right.b)


def p_asof_now_join_left_retraction(pw):
    t1, t2 = _md(pw, """
        k | a | __time__ | __diff__
        x | 1 | 2        | 1
        y | 2 | 4        | 1
        x | 1 | 6        | -1
        """, """
        k | b | __time__
        x | 10 | 2
        x | 20 | 4
        """)
    return pw.temporal.asof_now_join_left(t1, t2, t1.k == t2.k).select(pw.left.a, pw.right.b)


def p_sort_prev_next(pw):
    (t,) = _md(pw, """
        v
        30
        10
        20
        """)
    ptrs = t.sort(t.v)
    return t.select(t.v, nxt=t.ix(ptrs.next, optional=True).v,
                    prv=t.ix(ptrs.prev, optional=True).v)


def p_diff(pw):
    (t,) = _md(pw, """
        t | v
        1 | 10
        2 | 13
        3 | 19
        """)
    return t.diff(t.t, t.v)


def p_diff_this(pw):
    (t,) = _md(pw, """
        t | v
        1 | 10
        2 | 13
        3 | 11
        """)
    return t.diff(pw.this.t, pw.this.v)


def p_diff_instance_streaming(pw):
    (t,) = _md(pw, """
        t | g | v  | __time__ | __diff__
        1 | a | 10 | 2        | 1
        3 | a | 13 | 2        | 1
        1 | b | 5  | 2        | 1
        2 | a | 11 | 4        | 1
        2 | b | 7  | 4        | 1
        3 | a | 13 | 6        | -1
        """)
    return t.diff(t.t, t.v, instance=t.g)


def p_interpolate(pw):
    (t,) = _md(pw, """
        t | v
        1 | 1.0
        2 |
        4 |
        5 | 9.0
        7 |
        """)
    return t.interpolate(t.t, t.v)


def p_interpolate_streaming(pw):
    (t,) = _md(pw, """
        t | v   | __time__
        0 | 0.0 | 2
        4 |     | 2
        8 | 8.0 | 4
        6 |     | 6
        """)
    return t.interpolate(t.t, t.v)


def p_deduplicate(pw):
    (t,) = _md(pw, """
        v | __time__
        1 | 2
        5 | 4
        3 | 6
        8 | 8
        """)
    return t.deduplicate(value=t.v, acceptor=lambda new, old: old is None or new > old)


def p_behavior_delay_cutoff_stream(pw):
    """delay and cutoff together, keep_results on: the buffer after the
    freeze (the JAX order), rows released as the watermark passes."""
    (t,) = _md(pw, """
        t  | v | __time__
        1  | 1 | 2
        3  | 2 | 2
        7  | 4 | 4
        12 | 8 | 6
        2  | 16 | 8
        30 | 32 | 10
        6  | 64 | 12
        """)
    return t.windowby(t.t, window=pw.temporal.tumbling(duration=5),
                      behavior=pw.temporal.common_behavior(delay=2, cutoff=6)).reduce(
        start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v), n=pw.reducers.count())


def p_exactly_once_behavior(pw):
    (t,) = _md(pw, """
        t  | v | __time__
        1  | 1 | 2
        4  | 2 | 4
        6  | 4 | 6
        3  | 8 | 8
        13 | 16 | 10
        """)
    return t.windowby(t.t, window=pw.temporal.tumbling(duration=5),
                      behavior=pw.temporal.exactly_once_behavior()).reduce(
        start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))


def p_apply_temporal_behavior(pw):
    (t,) = _md(pw, """
        _pw_time | v | __time__
        1        | 1 | 2
        8        | 2 | 4
        2        | 4 | 6
        20       | 8 | 8
        """)
    return pw.temporal.apply_temporal_behavior(
        t, pw.temporal.common_behavior(delay=1, cutoff=3, keep_results=False))


def p_buffer_chain(pw):
    """Two buffers in a row whose thresholds the stream never reaches: the
    end-of-stream flush rounds release the first, then the second."""
    (t,) = _md(pw, """
        t | v | __time__
        1 | 1 | 2
        5 | 2 | 4
        3 | 4 | 6
        """)
    first = t._buffer(t.t + 100, t.t)
    return first._buffer(first.t + 50, first.t).select(first.t, first.v)


def p_flatten_keys(pw):
    """The flatten windowby rides on: its row keys (one per element
    position) equal JAX's, retractions included."""
    (t,) = _md(pw, """
        n | __time__ | __diff__
        1 | 2        | 1
        3 | 2        | 1
        2 | 4        | 1
        3 | 6        | -1
        """)
    t = t.select(t.n, xs=pw.apply_with_type(lambda n: tuple(range(n)), tuple, t.n))
    return t.flatten(t.xs)


def p_intervals_over(pw):
    t, at = _md(pw, """
        t | v
        1 | 1
        2 | 2
        4 | 4
        9 | 8
        """, """
        at
        2
        9
        20
        """)
    return t.windowby(t.t, window=pw.temporal.intervals_over(
        at=at.at, lower_bound=-1, upper_bound=2)).reduce(
        loc=pw.this._pw_window_location, n=pw.reducers.count())


def p_session_window_join(pw):
    t1, t2 = _md(pw, """
        t  | a
        1  | x
        10 | y
        """, """
        t  | b
        2  | p
        4  | q
        30 | r
        """)
    return pw.temporal.window_join_outer(t1, t2, t1.t, t2.t,
                                         pw.temporal.session(max_gap=2)).select(
        pw.left.a, pw.right.b)


def p_window_join_sliding_left(pw):
    t1, t2 = _md(pw, """
        t | a
        1 | x
        5 | y
        """, """
        t | b
        3 | p
        """)
    return pw.temporal.window_join_left(t1, t2, t1.t, t2.t,
                                        pw.temporal.sliding(hop=2, duration=4)).select(
        pw.left.a, pw.right.b)


def p_asof_join_outer_on_key(pw):
    t1, t2 = _md(pw, """
        t | k | a
        5 | u | x
        2 | v | y
        """, """
        t | k | b
        3 | u | p
        4 | v | q
        1 | w | r
        """)
    return pw.temporal.asof_join_outer(t1, t2, t1.t, t2.t, t1.k == t2.k).select(
        pw.left.a, pw.right.b)


def p_interval_join_star_select(pw):
    t1, t2 = _md(pw, """
        t | a
        3 | x
        """, """
        t | b
        3 | p
        """)
    return pw.temporal.interval_join(t1, t2, t1.t, t2.t, pw.temporal.interval(0, 0)).select(
        *pw.left, pw.right.b)


INNER_LR = ("""
    t | a
    3 | x
    5 | y
    """, """
    t | b
    3 | p
    6 | q
    """)

PROGRAMS = {
    # tests/test_temporal.py
    "tumbling_window": _window(TV, _tumbling5, start=_start, s=_sum_v),
    "sliding_window": _window("""
        t | v
        4 | 1
        """, lambda tp: tp.sliding(hop=2, duration=4), start=_start, c=_count),
    "session_window": _window("""
        t  | v
        1  | 1
        2  | 2
        10 | 3
        """, lambda tp: tp.session(max_gap=3), start=_start,
        end=lambda pw: pw.this._pw_window_end, s=_sum_v),
    "windowby_instance": _window("""
        t | g | v
        1 | a | 1
        2 | a | 2
        1 | b | 5
        """, _tumbling5, instance="g", s=_sum_v),
    "interval_join": _join("interval_join", """
        t | a
        3 | x
        7 | y
        """, """
        t | b
        2 | p
        4 | q
        9 | r
        """, _interval(-1, 1)),
    "asof_join": _join("asof_join", """
        t | a
        3 | x
        8 | y
        """, """
        t | b
        1 | p
        5 | q
        """, direction="backward"),
    "window_join": _join("window_join", """
        t | a
        1 | x
        6 | y
        """, """
        t | b
        2 | p
        7 | q
        """, _tumbling5),
    "asof_now_join": p_asof_now_join,
    "sort_prev_next": p_sort_prev_next,
    "diff": p_diff,
    "deduplicate": p_deduplicate,
    # tests/test_temporal_edges.py
    "interval_join_empty_interval_point_match": _join("interval_join", *INNER_LR,
                                                      _interval(0, 0)),
    "interval_join_shifted_interval": _join("interval_join", """
        t | a
        1 | x
        """, """
        t | b
        2 | p
        3 | q
        4 | r
        5 | s
        """, _interval(2, 3)),
    "interval_join_non_symmetric_negative": _join("interval_join", """
        t | a
        5 | x
        """, """
        t | b
        1 | p
        3 | q
        5 | r
        """, _interval(-3, -1)),
    "interval_join_float_bounds": _join("interval_join", """
        t   | a
        1.0 | x
        """, """
        t    | b
        1.4  | p
        1.6  | q
        """, _interval(-0.5, 0.5)),
    "interval_join_non_overlapping_times_inner_empty": _join("interval_join", """
        t | a
        1 | x
        """, """
        t  | b
        10 | p
        """, _interval(-1, 1)),
    "interval_join_outer_pads_unmatched": _join("interval_join", """
        t | a
        1 | x
        """, """
        t  | b
        10 | p
        """, _interval(-1, 1), how="outer"),
    "interval_join_with_extra_on_condition": _join("interval_join", """
        t | k | a
        1 | u | x
        1 | v | y
        """, """
        t | k | b
        1 | u | p
        """, _interval(0, 0), on=True),
    "interval_join_expression_select": _join("interval_join", """
        t | a
        2 | 10
        """, """
        t | b
        2 | 7
        """, _interval(0, 0), select=lambda pw, r: r.select(
        s=pw.left.a + pw.right.b, dt=pw.right.t - pw.left.t)),
    "tumbling_window_boundary_belongs_to_next": _window("""
        t  | v
        0  | 1
        4  | 2
        5  | 4
        9  | 8
        10 | 16
        """, _tumbling5, s=_sum_v),
    "tumbling_window_origin_shifts_boundaries": _window("""
        t | v
        0 | 1
        4 | 2
        5 | 4
        """, lambda tp: tp.tumbling(duration=5, origin=4), s=_sum_v),
    "sliding_window_row_in_multiple_windows": _window("""
        t | v
        3 | 1
        """, lambda tp: tp.sliding(hop=2, duration=4), start=_start, s=_sum_v),
    "session_window_merges_across_gap_chain": _window("""
        t  | v
        1  | 1
        3  | 2
        5  | 4
        20 | 8
        """, lambda tp: tp.session(max_gap=3), s=_sum_v),
    "session_window_predicate_variant": _window("""
        t  | v
        1  | 1
        2  | 2
        10 | 4
        """, lambda tp: tp.session(predicate=lambda a, b: abs(a - b) <= 2), s=_sum_v),
    "windowby_instance_separates_groups": p_windowby_instance_column,
    "window_late_data_updates_result": _window("""
        t | v | __time__
        1 | 1 | 2
        2 | 2 | 4
        """, _tumbling5, s=_sum_v),
    "window_cutoff_behavior_ignores_very_late_rows": _window("""
        t  | v | __time__
        1  | 1 | 2
        20 | 5 | 4
        2  | 9 | 20
        """, _tumbling5, behavior=lambda tp: tp.common_behavior(cutoff=1), s=_sum_v),
    "window_keep_results_false_forgets_closed_windows": _window("""
        t  | v | __time__
        1  | 1 | 2
        50 | 5 | 40
        """, _tumbling5, behavior=lambda tp: tp.common_behavior(cutoff=0, keep_results=False),
        s=_sum_v),
    "asof_join_takes_latest_at_or_before": _join("asof_join", """
        t | a
        5 | x
        """, """
        t | b
        1 | p
        4 | q
        6 | r
        """),
    "asof_join_left_keeps_unmatched": _join("asof_join_left", """
        t | a
        1 | x
        """, """
        t | b
        5 | p
        """),
    "asof_join_with_key_condition": _join("asof_join", """
        t | k | a
        5 | u | x
        5 | v | y
        """, """
        t | k | b
        3 | u | p
        4 | v | q
        """, on=True),
    "asof_join_update_shifts_match": _join("asof_join", """
        t | a | __time__
        5 | x | 2
        """, """
        t | b | __time__
        1 | p | 2
        4 | q | 6
        """),
    "window_join_same_tumbling_window_pairs": _join("window_join", """
        t | a
        1 | x
        6 | y
        """, """
        t | b
        2 | p
        3 | q
        7 | r
        """, _tumbling5),
    "diff_computes_deltas_in_time_order": p_diff_this,
    "asof_join_forward_direction": _join("asof_join", """
        t | a
        5 | x
        """, """
        t | b
        3 | p
        7 | q
        9 | r
        """, direction="forward"),
    "asof_join_nearest_direction": _join("asof_join", """
        t | a
        5 | x
        """, """
        t | b
        2 | p
        6 | q
        """, direction="nearest"),
    "asof_join_defaults_fill_unmatched": _join("asof_join_left", """
        t | a
        1 | x
        """, """
        t | b
        5 | p
        """, defaults={"b": "none"}),
    "interval_join_right_mode_pads_right": _join("interval_join", """
        t | a
        1 | x
        """, """
        t  | b
        1  | p
        50 | q
        """, _interval(0, 0), how="right"),
    "interval_join_left_mode_pads_left": _join("interval_join", """
        t  | a
        1  | x
        50 | y
        """, """
        t | b
        1 | p
        """, _interval(0, 0), how="left"),
    "windowby_sliding_with_ratio": _window("""
        t | v
        1 | 1
        3 | 2
        """, lambda tp: tp.sliding(hop=2, ratio=2), s=_sum_v),
    # tests/test_streaming_semantics.py
    "stream_tumbling_window_reopens_on_late_row": _window("""
        t | v | __time__
        1 | 1 | 2
        7 | 2 | 4
        2 | 4 | 6
        """, _tumbling5, s=_sum_v),
    "stream_interval_join_matches_appear_incrementally": _join("interval_join", """
        t | a | __time__
        3 | x | 2
        """, """
        t | b | __time__
        3 | p | 4
        4 | q | 6
        """, _interval(0, 1)),
    "stream_asof_join_retracts_previous_best": _join("asof_join", """
        t | a | __time__
        5 | x | 2
        """, """
        t | b | __time__
        1 | p | 4
        4 | q | 6
        """),
    "stream_window_cutoff_no_updates_after_cutoff": _window("""
        t  | v | __time__
        1  | 1 | 2
        20 | 2 | 4
        2  | 9 | 6
        """, _tumbling5, behavior=lambda tp: tp.common_behavior(cutoff=1), s=_sum_v),
    # beyond the JAX tests: the rest of the surface
    "windowby_instance_positional_reduce": p_windowby_instance_positional,
    "asof_now_join_left_retraction": p_asof_now_join_left_retraction,
    "diff_instance_streaming": p_diff_instance_streaming,
    "interpolate": p_interpolate,
    "interpolate_streaming": p_interpolate_streaming,
    "behavior_delay_cutoff_stream": p_behavior_delay_cutoff_stream,
    "exactly_once_behavior": p_exactly_once_behavior,
    "apply_temporal_behavior": p_apply_temporal_behavior,
    "intervals_over": p_intervals_over,
    "buffer_chain_drains_at_end": p_buffer_chain,
    "flatten_keys": p_flatten_keys,
    "session_window_join_outer": p_session_window_join,
    "window_join_sliding_left": p_window_join_sliding_left,
    "asof_join_outer_on_key": p_asof_join_outer_on_key,
    "interval_join_star_select": p_interval_join_star_select,
}

# the JAX tests' own answers, as values of the final table (ids aside)
EXPECTED = {
    "tumbling_window": [(0, 11), (5, 5), (10, 4)],
    "sliding_window": [(2, 1), (4, 1)],
    "session_window": [(1, 2, 3), (10, 10, 3)],
    "windowby_instance": [(3,), (5,)],
    "interval_join": [("x", "p"), ("x", "q")],
    "asof_join": [("x", "p"), ("y", "q")],
    "window_join": [("x", "p"), ("y", "q")],
    "asof_now_join": [(1, 10)],
    "deduplicate": [(8,)],
    "interval_join_empty_interval_point_match": [("x", "p")],
    "interval_join_shifted_interval": [("x", "q"), ("x", "r")],
    "interval_join_non_symmetric_negative": [("x", "q")],
    "interval_join_float_bounds": [("x", "p")],
    "interval_join_non_overlapping_times_inner_empty": [],
    "interval_join_outer_pads_unmatched": [(None, "p"), ("x", None)],
    "interval_join_with_extra_on_condition": [("x", "p")],
    "interval_join_expression_select": [(17, 0)],
    "tumbling_window_boundary_belongs_to_next": [(3,), (12,), (16,)],
    "tumbling_window_origin_shifts_boundaries": [(1,), (6,)],
    "sliding_window_row_in_multiple_windows": [(0, 1), (2, 1)],
    "session_window_merges_across_gap_chain": [(7,), (8,)],
    "session_window_predicate_variant": [(3,), (4,)],
    "windowby_instance_separates_groups": [("a", 3), ("b", 4)],
    "window_late_data_updates_result": [(3,)],
    "window_cutoff_behavior_ignores_very_late_rows": [(1,), (5,)],
    "window_keep_results_false_forgets_closed_windows": [(5,)],
    "asof_join_takes_latest_at_or_before": [("x", "q")],
    "asof_join_left_keeps_unmatched": [("x", None)],
    "asof_join_with_key_condition": [("x", "p"), ("y", "q")],
    "asof_join_update_shifts_match": [("x", "q")],
    "window_join_same_tumbling_window_pairs": [("x", "p"), ("x", "q"), ("y", "r")],
    "asof_join_forward_direction": [("x", "q")],
    "asof_join_nearest_direction": [("x", "q")],
    "interval_join_right_mode_pads_right": [(None, "q"), ("x", "p")],
    "interval_join_left_mode_pads_left": [("x", "p"), ("y", None)],
    "buffer_chain_drains_at_end": [(1, 1), (3, 4), (5, 2)],
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_temporal_program_equals_jax(name):
    (j_final, j_stream), (t_final, t_stream) = _both(PROGRAMS[name])
    assert t_final[1] == j_final[1]
    assert t_final[0] == j_final[0]
    assert t_stream == j_stream
    if name in EXPECTED:
        assert _values(t_final) == sorted(EXPECTED[name], key=repr)


def test_stream_pins_of_the_jax_streaming_tests():
    """The update-stream facts ``tests/test_streaming_semantics.py``
    asserts, on the port's streams."""
    def stream(name):
        return [(tm, row, add) for _k, row, tm, add in _run("torch", PROGRAMS[name])[1]]

    ups = stream("stream_tumbling_window_reopens_on_late_row")
    assert {(2, (1,), True), (4, (2,), True), (6, (1,), False), (6, (5,), True)} <= set(ups)
    ups = stream("stream_interval_join_matches_appear_incrementally")
    assert {(4, ("x", "p"), True), (6, ("x", "q"), True)} <= set(ups)
    assert all(add for *_x, add in ups)
    ups = stream("stream_asof_join_retracts_previous_best")
    assert {(4, ("x", "p"), True), (6, ("x", "p"), False), (6, ("x", "q"), True)} <= set(ups)
    ups = stream("stream_window_cutoff_no_updates_after_cutoff")
    assert all(tm != 6 for tm, *_x in ups)


def test_windows_validate_their_arguments():
    for pkg in PACKAGES:
        temporal = PW[pkg].temporal
        for kw in ({"duration": 4}, {"hop": 2}, {"ratio": 2}):
            with pytest.raises(ValueError):
                temporal.sliding(**kw)
        assert temporal.sliding(hop=2, ratio=2).duration == 4
        PW[pkg].clear_graph()
        t1, t2 = _md(PW[pkg], *INNER_LR)
        with pytest.raises(ValueError):
            temporal.interval_join(t1, t2, t1.t, t2.t, temporal.interval(0, 1), t1.t != t2.t)
        with pytest.raises(TypeError):
            temporal.apply_temporal_behavior(t1, temporal.exactly_once_behavior())
        PW[pkg].clear_graph()


# ------------------------------------------ tests/test_incremental_equivalence.py
# random insert / retract streams in one commit and spread over many; each
# package's final state and update stream equal the other's, and each
# package's spread final state equals its own one-commit state

KDOM = ["a", "b", "c", "d", "e"]


def _gen_events(rng, n, vmax=20):
    live, events = [], []
    for _ in range(n):
        if live and rng.random() < 0.35:
            row = live.pop(rng.randrange(len(live)))
            events.append((*row, -1))
        else:
            row = (rng.choice(KDOM), rng.randrange(vmax))
            if row in live:
                continue
            live.append(row)
            events.append((*row, 1))
    return events


def _times_single(events):
    return [(*e[:-1], 2, e[-1]) for e in events]


def _times_spread(rng, events):
    t, out = 2, []
    for e in events:
        if rng.random() < 0.4:
            t += 2
        out.append((*e[:-1], t, e[-1]))
    return out


EQUIVALENCE = {
    "tumbling_window": (1, 60, lambda pw, t: t.windowby(
        t.v, window=pw.temporal.tumbling(duration=5)).reduce(
        s=pw.reducers.sum(pw.this.v), n=pw.reducers.count())),
    "interval_join": (2, 25, lambda pw, t1, t2: pw.temporal.interval_join(
        t1, t2, t1.v, t2.v, pw.temporal.interval(-2, 2)).select(
        k1=pw.left.k, k2=pw.right.k, tl=pw.left.v, tr=pw.right.v)),
    "asof_join": (2, 25, lambda pw, t1, t2: pw.temporal.asof_join(
        t1, t2, t1.v, t2.v, t1.k == t2.k, direction="backward").select(
        k=pw.left.k, tl=pw.left.v, tr=pw.right.v)),
    "session_window": (1, 60, lambda pw, t: t.windowby(
        t.v, window=pw.temporal.session(max_gap=2)).reduce(
        n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))),
}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("case", sorted(EQUIVALENCE))
def test_incremental_equivalence_equals_jax(case, seed):
    n_tables, n, program = EQUIVALENCE[case]
    rng = random.Random(seed)
    streams = [_gen_events(rng, n) for _ in range(n_tables)]
    arms = {"single": [_times_single(ev) for ev in streams],
            "spread": [_times_spread(rng, ev) for ev in streams]}

    def build_for(rows_lists):
        def build(pw):
            schema = pw.schema_from_types(k=str, v=int)
            return program(pw, *[pw.debug.table_from_rows(schema, rows, is_stream=True)
                                 for rows in rows_lists])
        return build

    finals = {}
    for arm, rows_lists in arms.items():
        (j_final, j_stream), (t_final, t_stream) = _both(build_for(rows_lists))
        assert t_final == j_final, arm
        assert t_stream == j_stream, arm
        finals[arm] = t_final
    assert finals["spread"] == finals["single"]


# ------------------------------------------------------------- a datetime window


def p_datetime_window(pw):
    """The pandas path: ``DateTimeNaive`` times parsed with ``strptime``,
    a ``Duration`` window and delay."""
    (t,) = _md(pw, """
        ts                  | v | __time__
        2024-01-01T10:00:00 | 1 | 2
        2024-01-01T10:04:00 | 2 | 2
        2024-01-01T10:07:00 | 4 | 4
        2024-01-01T10:16:00 | 8 | 6
        2024-01-01T10:02:00 | 16 | 8
        """)
    t = t.with_columns(ts=t.ts.dt.strptime("%Y-%m-%dT%H:%M:%S"))
    return t.windowby(t.ts, window=pw.temporal.sliding(
        hop=pw.Duration(minutes=5), duration=pw.Duration(minutes=10)),
        behavior=pw.temporal.common_behavior(delay=datetime.timedelta(minutes=1))).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end,
        s=pw.reducers.sum(pw.this.v), last=pw.reducers.max(pw.this.ts))


def p_datetime_interval_join(pw):
    t1, t2 = _md(pw, """
        ts                  | a
        2024-01-01T10:00:00 | x
        2024-01-01T11:00:00 | y
        """, """
        ts                  | b
        2024-01-01T09:58:00 | p
        2024-01-01T10:30:00 | q
        """)
    t1 = t1.with_columns(t=t1.ts.dt.strptime("%Y-%m-%dT%H:%M:%S"))
    t2 = t2.with_columns(t=t2.ts.dt.strptime("%Y-%m-%dT%H:%M:%S"))
    return pw.temporal.interval_join(t1, t2, t1.t, t2.t, pw.temporal.interval(
        -pw.Duration(minutes=5), pw.Duration(minutes=0))).select(pw.left.a, pw.right.b)


@pytest.mark.parametrize("build", [p_datetime_window, p_datetime_interval_join],
                         ids=["sliding_window", "interval_join"])
def test_datetime_programs_equal_jax(build):
    (j_final, j_stream), (t_final, t_stream) = _both(build)
    assert t_final == j_final
    assert t_stream == j_stream
    assert t_final[0]


def test_default_origins_and_joint_types():
    from pathway_tpu.stdlib.temporal import utils as j_utils
    from pathway_tpu_torch.internals import dtype as t_dt
    from pathway_tpu.internals import dtype as j_dt
    from pathway_tpu_torch.stdlib.temporal import utils as t_utils

    for name in ("INT", "FLOAT", "DATE_TIME_NAIVE", "DATE_TIME_UTC"):
        assert t_utils.get_default_origin(getattr(t_dt, name)) == j_utils.get_default_origin(
            getattr(j_dt, name))
    for typ in (int, float, datetime.timedelta):
        assert t_utils.zero_length_interval(typ) == j_utils.zero_length_interval(typ)
    for utils in (t_utils, j_utils):
        utils.check_joint_types({"t": (3, utils.TimeEventType), "i": (2, utils.IntervalType)})
        with pytest.raises(TypeError):
            utils.check_joint_types({"t": (3, utils.TimeEventType),
                                     "i": (2.0, utils.IntervalType)})


# ------------------------------------------------------------ without pandas

_NO_PANDAS = textwrap.dedent("""
    import json, sys
    sys.modules["pandas"] = None
    import pathway_tpu_torch as pw

    docs = pw.debug.table_from_rows(pw.schema_from_types(t=int, g=int, v=int),
                                    [(i * 3 % 17, i % 2, i) for i in range(24)])
    wins = docs.windowby(docs.t, window=pw.temporal.sliding(hop=2, duration=6),
                         behavior=pw.temporal.common_behavior(delay=1, cutoff=4),
                         instance=docs.g).reduce(pw.this.g, start=pw.this._pw_window_start,
                                                 n=pw.reducers.count(),
                                                 last=pw.reducers.max(pw.this.t))
    d = wins.diff(wins.start, wins.n, instance=wins.g)
    pairs = pw.temporal.interval_join(docs, docs.copy(), docs.t, docs.t,
                                      pw.temporal.interval(-1, 0)).select(pw.left.v)
    near = pw.temporal.asof_join(docs, wins, docs.t, wins.last).select(pw.left.v, pw.right.n)
    out = {name: len(pw.debug.table_to_dicts(tab)[0])
           for name, tab in (("windows", d), ("pairs", pairs), ("asof", near))}
    print(json.dumps({"rows": out, "pandas": sys.modules["pandas"] is not None}))
""")


def test_int_windowby_runs_without_pandas():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["pandas"] is False
    assert all(n > 0 for n in out["rows"].values()), out


# ------------------------------------------------------------------ namespaces


@pytest.mark.parametrize("module", ["temporal", "ordered", "statistical", "indexing.sorting"])
def test_public_names_equal_jax(module):
    def public(pkg):
        obj = PW[pkg]
        for part in module.split("."):
            obj = getattr(obj, part)
        return {n for n in dir(obj) if not n.startswith("_")}

    assert public("torch") == public("jax")


def test_result_classes_and_reexports():
    for name in ("AsofJoinResult", "IntervalJoinResult", "WindowJoinResult"):
        assert getattr(TPW, name) is getattr(TPW.temporal, name)
    assert TPW.statistical.InterpolateMode.LINEAR.value == 0
    assert sorted(TPW.temporal.__all__) == sorted(JPW.temporal.__all__)


# -------------------------------------------------------------- node level
# the engine nodes stepped with the same batches on both packages: every
# step's output (keys, rows, diffs, in order) and the end-of-stream flush

E = object()  # stands for the package's ERROR in a row

MODS = {"jax": (j_graph, j_batch, j_temporal, j_ir, j_asof_now, J_ERROR),
        "torch": (t_graph, t_batch, t_temporal, t_ir, t_asof_now, T_ERROR)}


def _rows(pkg, rows):
    err = MODS[pkg][5]
    return [(k, tuple(err if v is E else v for v in row), d) for k, row, d in rows]


def _out(batch):
    if batch is None:
        return None
    return [(int(k), tuple(canon(v) for v in row), int(d)) for k, row, d in batch.rows()]


def _step_all(pkg, node_of, cols, steps, flush=False):
    g_mod, b_mod = MODS[pkg][:2]
    g = g_mod.EngineGraph()
    inputs = [g_mod.Node(g, [], list(c), f"in{i}") for i, c in enumerate(cols)]
    node = node_of(pkg, g, inputs)
    outs = []
    for t, step in enumerate(steps):
        batches = [None if rows is None else b_mod.Batch.from_rows(list(c), _rows(pkg, rows))
                   for c, rows in zip(cols, step)]
        outs.append(_out(node.step(t, batches)))
    if flush:
        outs.append(sorted((int(k), tuple(canon(v) for v in row), int(d))
                           for k, row, d in node.flush()))
    return outs


BEHAVIOR_STEPS = [
    [[(1, (5, 1, "a"), 1), (2, (3, 2, "b"), 1), (3, (E, 2, "c"), 1)]],
    [[(4, (9, 4, "d"), 1), (2, (3, 2, "b"), -1), (5, (4, E, "e"), 1)]],
    [[(6, (2, 3, "f"), 1), (1, (5, 1, "a"), -1)]],
    [[(7, (20, 12, "g"), 1)]],
    [None],
    [[(8, (6, 13, "h"), 1), (4, (9, 4, "d"), -1), (9, (30, 14, "i"), 1)]],
]


@pytest.mark.parametrize("kind", ["BufferNode", "ForgetNode", "ForgetNode-mark", "FreezeNode"])
def test_behavior_nodes_step_equal_jax(kind):
    cls_name, _, mark = kind.partition("-")

    def node_of(pkg, g, inputs):
        cls = getattr(MODS[pkg][2], cls_name)
        kw = {"mark_forgetting_records": True} if mark else {}
        return cls(g, inputs[0], "thr", "t", **kw)

    cols = [("thr", "t", "v")]
    flush = cls_name == "BufferNode"
    want = _step_all("jax", node_of, cols, BEHAVIOR_STEPS, flush=flush)
    got = _step_all("torch", node_of, cols, BEHAVIOR_STEPS, flush=flush)
    assert got == want
    assert any(o for o in got)


def test_sort_node_steps_equal_jax():
    steps = [
        [[(1, (30, "a"), 1), (2, (10, "a"), 1), (3, (20, "b"), 1), (4, (20, "a"), 1)]],
        [[(5, (15, "a"), 1), (2, (10, "a"), -1)]],
        [[(6, (20, "a"), 1)]],  # a tie on the sort value: the key breaks it
        [[(3, (20, "b"), -1), (7, (1, "b"), 1)]],
        [[(1, (30, "a"), -1), (4, (20, "a"), -1), (5, (15, "a"), -1), (6, (20, "a"), -1)]],
    ]

    for inst in ("g", None):
        def node_of(pkg, g, inputs, inst=inst):
            return MODS[pkg][2].SortNode(g, inputs[0], "v", inst)

        want = _step_all("jax", node_of, [("v", "g")], steps)
        got = _step_all("torch", node_of, [("v", "g")], steps)
        assert got == want
        assert all(o for o in got)


def test_instance_recompute_node_steps_equal_jax():
    def compute(inst, left, right):
        if inst == "boom":
            raise ValueError("compute failed")
        total = sum(r[1] for r in left.values()) - sum(r[1] for r in right.values())
        return {hash(inst) & 0xFFFF: (inst, total, len(left), len(right))} if left else {}

    def node_of(pkg, g, inputs):
        return MODS[pkg][3].InstanceRecomputeNode(
            g, inputs, ["g", "g"], ["g", "total", "nl", "nr"], compute)

    steps = [
        [[(1, ("a", 5), 1), (2, ("b", 3), 1)], None],
        [None, [(10, ("a", 1), 1)]],
        [[(3, ("a", 2), 1), (4, (E, 9), 1), (5, ("boom", 1), 1)], [(11, ("b", 7), 1)]],
        [[(1, ("a", 5), -1), (2, ("b", 3), -1)], None],
        [[(3, ("a", 2), -1)], [(10, ("a", 1), -1)]],
    ]
    cols = [("g", "x"), ("g", "y")]
    want = _step_all("jax", node_of, cols, steps)
    got = _step_all("torch", node_of, cols, steps)
    assert got == want
    assert got[0] and got[3]


@pytest.mark.parametrize("arm", ["native", "python"])
@pytest.mark.parametrize("mode", ["inner", "left"])
def test_asof_now_join_node_steps_equal_jax(mode, arm):
    spec = [("a", "left", "a"), ("b", "right", "b")]

    def node_of(pkg, g, inputs):
        cls = MODS[pkg][4].AsofNowJoinNode
        if pkg == "jax":
            return cls(g, inputs[0], inputs[1], ["k"], ["k"], mode, spec, key_mode="left")
        return cls(g, inputs[0], inputs[1], ["k"], ["k"], mode, spec, key_mode="left",
                   native=arm == "native")

    steps = [
        [None, [(10, ("x", 1), 1), (11, ("x", 2), 1)]],
        [[(1, ("x", "p"), 1), (2, ("y", "q"), 1), (3, (E, "r"), 1)], None],
        [[(4, ("x", "s"), 1)], [(12, ("x", 3), 1), (10, ("x", 1), -1)]],  # no retrigger
        [[(1, ("x", "p"), -1), (2, ("y", "q"), -1)], [(13, ("y", 4), 1)]],
        [[(5, ("y", "t"), 1)], None],
    ]
    cols = [("k", "a"), ("k", "b")]
    saved = j_join._native_lib
    if arm == "python":
        j_join._native_lib = None
    try:
        want = _step_all("jax", node_of, cols, steps)
    finally:
        j_join._native_lib = saved
    got = _step_all("torch", node_of, cols, steps)
    assert got == want
    assert got[1] and got[3]


# ------------------------------------------ the slice: chip_smoke phase 19, small
# 512 docs of 2 topics with a seeded jitter on their event times and 1%
# late docs produced last, streamed through a broker in commits of 64
# (each epoch at most 64 docs, so no late doc reaches a window); the
# embed UDF of the small test encoder; sliding windows with delay and
# cutoff, their diff, an interval join of 16 queries to the docs and an
# as-of join of the queries to the windows

N_DOCS, N_TOPICS, N_Q, COMMIT = 512, 2, 16, 64
HOP, DURATION, DELAY, CUTOFF, JITTER, LOOKBACK = 64, 256, 32, 128, 16, 128
VOCAB, MAX_LEN = 1000, 64


def slice_feed(seed=19):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "stream", "tensor", "index"]
    texts = [" ".join(rng.choice(words, 12)) for _ in range(N_DOCS)]
    t = np.arange(N_DOCS) + rng.integers(-JITTER, JITTER + 1, N_DOCS)
    late = np.sort(rng.choice(N_DOCS, N_DOCS // 100, replace=False))
    t[late] = rng.integers(0, N_DOCS // 4, len(late))
    order = [i for i in range(N_DOCS) if i not in set(late.tolist())] + late.tolist()
    docs = [{"doc": int(i), "topic": int(i % N_TOPICS), "t": int(t[i]), "text": texts[i]}
            for i in order]
    q_t = np.sort(rng.integers(DURATION, N_DOCS, N_Q))
    queries = [{"q": j, "topic": j % N_TOPICS, "t": int(q_t[j]),
                "text": " ".join(rng.choice(words, 4))} for j in range(N_Q)]
    return docs, queries, set(late.tolist())


def paced_feed(broker, connectors, topic, payloads, chunk, timeout):
    """Produces ``payloads`` in commits of ``chunk``, each once the
    reader has taken the one before: each epoch of the reader holds at
    most ``chunk`` rows."""
    reader = next(c for c in connectors if getattr(c, "topic", None) == topic)
    deadline = time.time() + timeout
    for s in range(0, len(payloads), chunk):
        for p in payloads[s:s + chunk]:
            broker.produce(topic, p)
        end = min(s + chunk, len(payloads))
        while reader._offset < end:
            if time.time() > deadline:
                raise TimeoutError(f"the {topic!r} reader stalled at {reader._offset}")
            time.sleep(0.002)


def slice_program(pw, emb, broker):
    """Phase 19's program; returns its tables."""
    class DocSchema(pw.Schema):
        doc: int
        topic: int
        t: int
        text: str

    class QuerySchema(pw.Schema):
        q: int
        topic: int
        t: int
        text: str

    docs = pw.io.kafka.read(broker, topic="docs", schema=DocSchema)
    docs = docs.with_columns(vec=emb(docs.text))
    windows = docs.windowby(
        docs.t, window=pw.temporal.sliding(hop=HOP, duration=DURATION),
        behavior=pw.temporal.common_behavior(delay=DELAY, cutoff=CUTOFF),
        instance=docs.topic).reduce(
        pw.this.topic, start=pw.this._pw_window_start, n=pw.reducers.count(),
        centroid=pw.reducers.npsum(pw.this.vec), last=pw.reducers.max(pw.this.t))
    diffs = windows.diff(windows.start, windows.n, instance=windows.topic)
    queries = pw.io.kafka.read(broker, topic="queries", schema=QuerySchema)
    queries = queries.with_columns(vec=emb(queries.text))
    pairs = pw.temporal.interval_join(
        queries, docs, queries.t, docs.t, pw.temporal.interval(-LOOKBACK, 0),
        queries.topic == docs.topic).select(
        q=pw.left.q, doc=pw.right.doc,
        score=pw.apply(lambda a, b: float(np.dot(a, b)), pw.left.vec, pw.right.vec))
    best = pairs.groupby(pairs.q).reduce(pairs.q, arg=pw.reducers.argmax(pairs.score),
                                         top=pw.reducers.max(pairs.score))
    best = best.select(best.q, best.top, doc=pairs.ix(best.arg).doc)
    asof = pw.temporal.asof_join(
        queries, windows, queries.t, windows.last, queries.topic == windows.topic).select(
        q=pw.left.q, start=pw.right.start, last=pw.right.last,
        cos=pw.apply(lambda a, c: float(np.dot(a, c) / np.linalg.norm(c)),
                     pw.left.vec, pw.right.centroid))
    return {"windows": windows, "diffs": diffs, "best": best, "asof": asof}


def run_slice(pw, emb, timeout=120.0):
    """One run of the program over the paced feed; the final tables as
    ``{name: {row id: row}}`` and the docs reader's connector stats."""
    docs, queries, _late = slice_feed()
    pw.clear_graph()
    broker = import_module(f"{pw.__name__}.io.kafka").InMemoryKafkaBroker()
    tables = slice_program(pw, emb, broker)
    finals = {n: {} for n in tables}
    lock = threading.Lock()

    def sink(name):
        def on_change(key, row, time, is_addition):
            with lock:
                if is_addition:
                    finals[name][key.value] = row
                elif finals[name].get(key.value) == row:
                    del finals[name][key.value]
        return on_change

    for name, tab in tables.items():
        pw.io.subscribe(tab, on_change=sink(name))
    connectors = list(pw.G.connectors)
    failure = []

    def feeder():
        try:
            paced_feed(broker, connectors, "docs", [json.dumps(d).encode() for d in docs],
                       COMMIT, timeout)
            paced_feed(broker, connectors, "queries",
                       [json.dumps(q).encode() for q in queries], N_Q, timeout)
        except Exception as exc:  # noqa: BLE001 - reported by the caller
            failure.append(exc)
        finally:
            broker.close()

    thread = threading.Thread(target=feeder, daemon=True)
    thread.start()
    pw.run()
    thread.join(timeout)
    assert not failure, failure
    reader = next(c for c in connectors if getattr(c, "topic", None) == "docs")
    stats = import_module(f"{pw.__name__}.internals.run").LAST_RUN_STATS
    return finals, stats.connectors[reader.node.id]


@pytest.fixture(scope="module")
def slice_models():
    from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
    from pathway_tpu.models.tokenizer import HashTokenizer as JTok
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from tests.torch_parity import configs, np_encoder_params, to_jax

    npp = np_encoder_params(seed=4)
    jcfg, tcfg = configs("float32")
    jm = JEmbed(jcfg, params=to_jax(npp), tokenizer=JTok(vocab_size=VOCAB, max_length=MAX_LEN),
                max_length=MAX_LEN)
    tm = SentenceEmbedderModel(tcfg, params=from_jax_params(npp),
                               tokenizer=HashTokenizer(vocab_size=VOCAB, max_length=MAX_LEN),
                               max_length=MAX_LEN, device="cpu")
    yield {"jax": jm, "torch": tm}
    jm.close()
    tm.close()


def _host_windows(docs, late):
    """{(topic, start): (n, last, [doc])} of the in-order docs."""
    out = {}
    for d in docs:
        if d["doc"] in late:
            continue
        k = (d["t"] - DURATION) // HOP + 1
        while k * HOP <= d["t"]:
            n, last, members = out.get((d["topic"], k * HOP), (0, None, []))
            out[(d["topic"], k * HOP)] = (n + 1, max(last, d["t"]) if last is not None
                                          else d["t"], members + [d["doc"]])
            k += 1
    return out


def test_phase19_slice_equals_jax_and_host(slice_models):
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JSTE
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TSTE

    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        cls = JSTE if pkg == "jax" else TSTE
        emb = cls(slice_models[pkg], max_batch_size=128, deferred=True)
        out[pkg] = run_slice(pw, emb)
        pw.clear_graph()
    (j, _), (t, reader) = out["jax"], out["torch"]
    docs, queries, late = slice_feed()
    host = _host_windows(docs, late)
    # the windows: counts and lasts exact, every late doc dropped, the same
    # row ids as JAX's; centroids within cosine 1 - 1e-4 of JAX's
    assert t["windows"].keys() == j["windows"].keys()
    got = {(r["topic"], r["start"]): (r["n"], r["last"]) for r in t["windows"].values()}
    assert got == {k: (n, last) for k, (n, last, _m) in host.items()}
    for key, row in t["windows"].items():
        a, b = row["centroid"], j["windows"][key]["centroid"]
        assert float(np.dot(a, b) / np.linalg.norm(a) / np.linalg.norm(b)) >= 1 - 1e-4
    # direct embeddings (the port's model, one batch): each centroid is
    # the sum of its docs' vectors
    text = {d["doc"]: d["text"] for d in docs}
    vec = dict(zip(text, slice_models["torch"].embed_batch(list(text.values()))))
    for row in t["windows"].values():
        want = np.sum([vec[i] for i in host[(row["topic"], row["start"])][2]], axis=0)
        cos = float(np.dot(row["centroid"], want) / np.linalg.norm(want)
                    / np.linalg.norm(row["centroid"]))
        assert cos >= 1 - 1e-4
    # the diff, the interval join's best docs and the as-of join equal JAX's
    for name in ("diffs", "best", "asof"):
        assert t[name].keys() == j[name].keys(), name
    for key, row in t["diffs"].items():
        assert {c: canon(v) for c, v in row.items() if c != "centroid"} == {
            c: canon(v) for c, v in j["diffs"][key].items() if c != "centroid"}
    for key, row in t["best"].items():
        assert row["q"] == j["best"][key]["q"] and abs(row["top"] - j["best"][key]["top"]) < 1e-4
        assert row["doc"] == j["best"][key]["doc"]
    for key, row in t["asof"].items():
        jr = j["asof"][key]
        assert (row["q"], row["start"], row["last"]) == (jr["q"], jr["start"], jr["last"])
        assert abs(row["cos"] - jr["cos"]) < 1e-4
    # against the host: diff of n by start within a topic; each query's
    # best doc by brute force over its topic and interval
    for row in t["diffs"].values():
        prev = (row["topic"], row["start"] - HOP)
        assert row["diff_n"] == (row["n"] - host[prev][0] if prev in host else None)
    by_q = {q["q"]: q for q in queries}
    qvec = dict(zip(by_q, slice_models["torch"].embed_batch([q["text"] for q in queries])))
    for row in t["best"].values():
        q = by_q[row["q"]]
        cand = [d["doc"] for d in docs if d["topic"] == q["topic"]
                and -LOOKBACK <= d["t"] - q["t"] <= 0]
        scores = {i: float(np.dot(qvec[q["q"]], vec[i])) for i in cand}
        assert row["doc"] == max(scores, key=scores.get)
        assert abs(row["top"] - max(scores.values())) < 1e-4
    assert len(t["best"]) == N_Q and len(t["asof"]) == N_Q
    # the docs came in commits of at most COMMIT rows, each its own epoch
    assert reader.rows_read == N_DOCS and reader.commits >= -(-N_DOCS // COMMIT)
