"""The port's joins held against the JAX package's, program by program:
the same tables go through both packages' ``join`` API and the final
tables (row ids and values) and the subscribe update streams (row id, row,
time, is_addition; in order) must be equal, pair keys and ``id=`` keys
included.

The cases are every test of ``tests/test_joins.py`` (its engine-level
ones drive both packages' ``JoinNode`` with the same batches), a
selection of ``tests/test_joins_matrix.py`` (each mode, duplicates,
id-preserving keys, chains, ``JoinResult.filter/reduce/groupby``,
retraction, the cross join on an empty key list that
``DocumentStore.statistics_query`` builds) and the port's C++ join loops
against its Python path (``JoinNode(native=False)``)."""

import numpy as np
import pytest

from pathway_tpu.engine import batch as j_batch
from pathway_tpu.engine import graph as j_graph
from pathway_tpu.engine.operators import join as j_join
from pathway_tpu_torch.engine import batch as t_batch
from pathway_tpu_torch.engine import graph as t_graph
from pathway_tpu_torch.engine.operators import join as t_join
from tests.torch_engine import PACKAGES, PW, canon, final_state, update_stream

LR = ("""
      a | k
      1 | x
      2 | y
      3 | z
      """, """
      b | k
      10 | y
      20 | z
      30 | w
      """)


def _lr(pw):
    return (pw.debug.table_from_markdown(LR[0]), pw.debug.table_from_markdown(LR[1]))


def _md(pw, *texts):
    return [pw.debug.table_from_markdown(t) for t in texts]


# ---------------------------------------------------------- table programs
# each builds one program against a package's ``pw`` and returns its table


def p_inner(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_left(pw):
    t1, t2 = _lr(pw)
    return t1.join_left(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_outer(pw):
    t1, t2 = _lr(pw)
    return t1.join_outer(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_right(pw):
    t1, t2 = _lr(pw)
    return t1.join_right(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_placeholders(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, pw.left.k == pw.right.k).select(pw.left.a, pw.right.b)


def p_id_left(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, t1.k == t2.k, id=t1.id).select(t1.a, t2.b)


def p_id_right(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, t1.k == t2.k, id=t2.id).select(t1.a, t2.b)


def p_left_id_pw_left(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, t1.k == t2.k, how=pw.JoinMode.LEFT, id=pw.left.id).select(
        pw.left.a, pw.right.b)


def p_incremental_retraction(pw):
    t1, t2 = _md(pw, """
        a | k | __time__ | __diff__
        1 | x | 2        | 1
        2 | y | 2        | 1
        2 | y | 6        | -1
        """, """
        b | k
        10 | x
        20 | y
        """)
    return t1.join(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_multi_condition(pw):
    t1, t2 = _md(pw, """
        a | b | v
        1 | 1 | p
        1 | 2 | q
        """, """
        a | b | w
        1 | 1 | P
        1 | 3 | R
        """)
    return t1.join(t2, t1.a == t2.a, t1.b == t2.b).select(t1.v, t2.w)


def p_join_then_filter(pw):
    t1, t2 = _lr(pw)
    res = t1.join(t2, t1.k == t2.k).select(t1.a, t2.b)
    return res.filter(res.b > 15)


def p_duplicates_both_sides(pw):
    t1, t2 = _md(pw, """
        a | k
        1 | x
        2 | x
        3 | y
        """, """
        b | k
        10 | x
        11 | x
        12 | y
        """)
    return t1.join(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_left_duplicate_right_keys(pw):
    t1, _ = _lr(pw)
    (r2,) = _md(pw, """
        b | k
        10 | y
        11 | y
        """)
    return t1.join_left(r2, t1.k == r2.k).select(t1.a, r2.b)


def p_outer_no_matches(pw):
    t1, t2 = _md(pw, """
        a | k
        1 | x
        """, """
        b | k
        5 | y
        """)
    return t1.join_outer(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_chained_inner(pw):
    t1, t2, t3 = _md(pw, """
        k | a
        x | 1
        y | 2
        """, """
        k | b
        x | 10
        y | 20
        """, """
        k | c
        x | 100
        """)
    return t1.join(t2, t1.k == t2.k).join(t3, t1.k == t3.k).select(t1.a, t2.b, t3.c)


def p_chained_left(pw):
    t1, t2, t3 = _md(pw, """
        k | a
        x | 1
        y | 2
        """, """
        k | b
        x | 10
        """, """
        k | c
        y | 200
        """)
    return (t1.join_left(t2, t1.k == t2.k).join_left(t3, pw.left.k == pw.right.k)
            .select(pw.this.a, pw.this.b, pw.this.c))


def p_chained_star_select(pw):
    t1, t2, t3 = _md(pw, """
        k | a
        x | 1
        """, """
        k | b
        x | 10
        """, """
        k | c
        x | 100
        """)
    return t1.join(t2, t1.k == t2.k).join(t3, t1.k == t3.k).select(pw.this)


def p_this_desugaring(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, pw.this.k == t2.k).select(pw.this.a, pw.this.b, s=pw.left.a + pw.right.b)


def p_outer_coalesce(pw):
    t1, t2 = _lr(pw)
    return t1.join_outer(t2, t1.k == t2.k).select(
        k=pw.coalesce(pw.left.k, pw.right.k), a=pw.left.a, b=pw.right.b)


def p_condition_on_expression(pw):
    t1, t2 = _md(pw, """
        a | v
        1 | p
        2 | q
        """, """
        a2 | w
        2  | P
        4  | Q
        """)
    return t1.join(t2, t1.a * 2 == t2.a2).select(t1.v, t2.w)


def p_cross_via_constant_key(pw):
    t1, t2 = _md(pw, """
        a
        1
        2
        """, """
        b
        10
        20
        """)
    l3, r3 = t1.with_columns(one=1), t2.with_columns(one=1)
    return l3.join(r3, l3.one == r3.one).select(l3.a, r3.b)


def p_cross_empty_key_list(pw):
    """``DocumentStore.statistics_query``'s shape: a cross join of two
    one-row reductions, then a left join keeping the query keys."""
    t1, t2 = _lr(pw)
    (queries,) = _md(pw, """
        q
        1
        2
        """)
    counts = t1.reduce(count=pw.reducers.count())
    top = t2.reduce(top=pw.reducers.max(t2.b))
    combined = counts.join(top).select(counts.count, top.top)
    return queries.join(combined, how="left", id=pw.left.id).select(
        pw.left.q, pw.right.count, pw.right.top)


def p_self_join(pw):
    (t,) = _md(pw, """
        a | k
        1 | x
        2 | x
        3 | y
        """)
    t2 = t.copy()
    return t.join(t2, t.k == t2.k).select(a1=t.a, a2=t2.a)


def p_bool_column(pw):
    t1, t2 = _md(pw, """
        a | flag
        1 | True
        2 | False
        """, """
        b | flag
        10 | True
        20 | True
        """)
    return t1.join(t2, t1.flag == t2.flag).select(t1.a, t2.b)


def p_none_keys(pw):
    t1, t2 = _md(pw, """
        a | k
        1 |
        2 | x
        """, """
        b | k
        10 |
        20 | x
        """)
    return t1.join(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_filter_then_groupby(pw):
    t1, t2 = _md(pw, """
        a | k
        1 | x
        2 | x
        3 | y
        """, """
        b | k
        10 | x
        20 | y
        """)
    filtered = t1.filter(t1.a < 3)
    return (filtered.join(t2, filtered.k == t2.k).select(pw.this.k, t2.b)
            .groupby(pw.this.k).reduce(pw.this.k, total=pw.reducers.sum(pw.this.b)))


def p_join_result_groupby(pw):
    t1, t2 = _md(pw, """
        a | k
        1 | x
        2 | x
        3 | y
        """, """
        b | k
        10 | x
        20 | y
        """)
    return t1.join(t2, t1.k == t2.k).groupby(pw.this.k).reduce(
        pw.this.k, n=pw.reducers.count(), s=pw.reducers.sum(pw.this.a))


def p_join_result_reduce(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, t1.k == t2.k).reduce(n=pw.reducers.count(),
                                            s=pw.reducers.sum(pw.this.a))


def p_join_result_filter(pw):
    t1, t2 = _lr(pw)
    return t1.join(t2, t1.k == t2.k).filter(pw.left.a > 2)


def p_left_streaming_match_later(pw):
    t1, t2 = _md(pw, """
        a | k | __time__
        1 | x | 2
        """, """
        b | k | __time__
        5 | x | 4
        """)
    return t1.join_left(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_outer_retracts_padding(pw):
    t1, t2 = _md(pw, """
        a | k | __time__
        1 | x | 2
        """, """
        b | k | __time__
        5 | x | 6
        """)
    return t1.join_outer(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_update_value_propagates(pw):
    t1, t2 = _md(pw, """
        a | k | __time__ | __diff__
        1 | x | 2        | 1
        1 | x | 4        | -1
        7 | x | 4        | 1
        """, """
        b | k
        5 | x
        """)
    return t1.join(t2, t1.k == t2.k).select(t1.a, t2.b)


def p_retract_both_sides_outer(pw):
    t1, t2 = _md(pw, """
        a | k | __time__ | __diff__
        1 | x | 2        | 1
        2 | y | 2        | 1
        2 | y | 6        | -1
        3 | y | 8        | 1
        """, """
        b | k | __time__ | __diff__
        10 | y | 4        | 1
        20 | x | 4        | 1
        20 | x | 8        | -1
        """)
    return t1.join_outer(t2, t1.k == t2.k, id=None).select(t1.a, t2.b)


def p_left_preserving_universe(pw):
    t1, t2 = _lr(pw)
    joined = t1.join_left(t2, t1.k == t2.k, id=t1.id).select(t2.b)
    return t1.with_columns(b=joined.b)


def p_outer_id_select(pw):
    t1, t2 = _lr(pw)
    return t1.join_outer(t2, t1.k == t2.k).select(id_col=pw.this.id, a=pw.left.a)


def p_join_on_id_columns(pw):
    (t1,) = _md(pw, """
        a
        1
        2
        """)
    t2 = t1.select(b=t1.a * 10)
    return t1.join(t2, t1.id == t2.id).select(t1.a, t2.b)


def p_instances(pw):
    t1, t2 = _md(pw, """
        k | g | a
        x | 1 | 1
        x | 2 | 2
        """, """
        k | g | b
        x | 1 | 10
        x | 2 | 20
        """)
    return t1.join(t2, t1.k == t2.k, left_instance=t1.g, right_instance=t2.g).select(
        t1.a, t2.b)


PROGRAMS = {
    # tests/test_joins.py
    "inner_join": p_inner,
    "left_join": p_left,
    "outer_join": p_outer,
    "join_left_right_placeholders": p_placeholders,
    "join_id_preservation": p_id_left,
    "join_incremental_retraction": p_incremental_retraction,
    "multi_condition_join": p_multi_condition,
    "join_filter": p_join_then_filter,
    # tests/test_joins_matrix.py
    "right_join": p_right,
    "id_from_right": p_id_right,
    "left_join_id_pw_left_JoinMode": p_left_id_pw_left,
    "inner_duplicates_both_sides": p_duplicates_both_sides,
    "left_duplicate_right_keys": p_left_duplicate_right_keys,
    "outer_no_matches": p_outer_no_matches,
    "chained_inner": p_chained_inner,
    "chained_left": p_chained_left,
    "chained_star_select": p_chained_star_select,
    "this_desugaring": p_this_desugaring,
    "outer_coalesce_key": p_outer_coalesce,
    "condition_on_expression": p_condition_on_expression,
    "cross_via_constant_key": p_cross_via_constant_key,
    "cross_empty_key_list_then_left_keep_ids": p_cross_empty_key_list,
    "self_join": p_self_join,
    "bool_column": p_bool_column,
    "none_keys": p_none_keys,
    "filter_then_groupby": p_filter_then_groupby,
    "join_result_groupby": p_join_result_groupby,
    "join_result_reduce": p_join_result_reduce,
    "join_result_filter": p_join_result_filter,
    "left_streaming_match_later": p_left_streaming_match_later,
    "outer_retracts_padding": p_outer_retracts_padding,
    "update_value_propagates": p_update_value_propagates,
    "retract_both_sides_outer": p_retract_both_sides_outer,
    "left_preserving_universe": p_left_preserving_universe,
    "outer_id_select": p_outer_id_select,
    "join_on_id_columns": p_join_on_id_columns,
    "instances": p_instances,
}


def _run(pkg, build):
    pw = PW[pkg]
    pw.clear_graph()
    final = final_state(pkg, build(pw))
    pw.clear_graph()
    stream = update_stream(pkg, build(pw))
    pw.clear_graph()
    return final, stream


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_join_program_equals_jax(name):
    jax_out, torch_out = (_run(pkg, PROGRAMS[name]) for pkg in PACKAGES)
    (j_rows, j_cols), j_stream = jax_out
    (t_rows, t_cols), t_stream = torch_out
    assert t_cols == j_cols
    assert t_rows == j_rows
    assert t_stream == j_stream
    assert j_rows or name in ("outer_no_matches",), "the program produced rows"


def test_join_result_types_and_groupby_class():
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t1, t2 = _lr(pw)
        assert type(t1.join(t2, t1.k == t2.k)).__name__ == "JoinResult"
        for how in ("left", "right", "outer"):
            assert type(t1.join(t2, t1.k == t2.k, how=how)).__name__ == "OuterJoinResult"
        jr = t1.join(t2, t1.k == t2.k)
        assert type(jr.groupby(pw.this.k)).__name__ == "GroupedJoinResult"
        assert sorted(jr.keys()) == ["a", "b", "k"]
        pw.clear_graph()


def test_join_dtypes_equal_jax():
    def schema_of(pkg, build):
        pw = PW[pkg]
        pw.clear_graph()
        tab = build(pw)
        return {n: repr(c.dtype) for n, c in tab.schema.__columns__.items()}

    for build in (p_left, p_right, p_outer, p_inner, p_id_left):
        assert schema_of("torch", build) == schema_of("jax", build)
    PW["torch"].clear_graph()
    PW["jax"].clear_graph()


def test_join_condition_must_be_equality():
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t1, t2 = _lr(pw)
        with pytest.raises(ValueError):
            t1.join(t2, t1.k != t2.k)
        pw.clear_graph()


# -------------------------------------------------------- JoinNode level
# tests/test_joins.py's engine-level cases, on both packages' JoinNode
# with the same batches: every step's output (keys, rows, diffs, in order)
# equal; the port's C++ loops and its Python path both


NODE_ARMS = ("native", "python")


def _node(pkg, arm="native", on=("uid",), left=("oid", "uid"), right=("uid", "name"),
          spec=(("oid", "left", "oid"), ("name", "right", "name")), mode="inner"):
    g_mod = j_graph if pkg == "jax" else t_graph
    g = g_mod.EngineGraph()
    lnode = g_mod.Node(g, [], list(left), "L")
    rnode = g_mod.Node(g, [], list(right), "R")
    if pkg == "jax":
        return j_join.JoinNode(g, lnode, rnode, list(on), list(on), mode, list(spec))
    return t_join.JoinNode(g, lnode, rnode, list(on), list(on), mode, list(spec),
                           native=arm == "native")


def _batch(pkg, cols, rows):
    if rows is None:
        return None
    return (j_batch if pkg == "jax" else t_batch).Batch.from_rows(list(cols), rows)


def _out(batch):
    if batch is None:
        return None
    return [(int(k), tuple(canon(v) for v in row), int(d)) for k, row, d in batch.rows()]


def _drive(pkg, arm, steps, **node_kw):
    """Outputs of one JoinNode over ``steps`` = [(left rows, right rows)].
    JAX's node takes the arm's path too: its Python path where its
    native library is unbound (as ``tests/test_joins.py`` selects it)."""
    if pkg == "jax":
        saved = j_join._native_lib
        if arm == "python":
            j_join._native_lib = None
        try:
            return _drive_node(pkg, arm, steps, **node_kw)
        finally:
            j_join._native_lib = saved
    return _drive_node(pkg, arm, steps, **node_kw)


def _drive_node(pkg, arm, steps, **node_kw):
    node = _node(pkg, arm, **node_kw)
    lcols = node_kw.get("left", ("oid", "uid"))
    rcols = node_kw.get("right", ("uid", "name"))
    return [_out(node.step(t, [_batch(pkg, lcols, lr), _batch(pkg, rcols, rr)]))
            for t, (lr, rr) in enumerate(steps)]


def _steps_hotkey():
    B = 64
    right = [(10**6 + i, (7, f"u{i}"), 1) for i in range(B)]
    steps = [(None, right)]
    steps += [([(t, (t, 7), 1)], None) for t in range(1, 9)]
    return steps


def _steps_hotkey_once():
    B = 64
    return [(None, [(10**6 + i, (7, f"u{i}"), 1) for i in range(B)]),
            ([(t, (t, 7), 1) for t in range(1, 9)], None)]


def _steps_reinsert():
    return [(None, [(900, (7, "u"), 1)]),
            ([(100, (1, 7), 1)], None),
            ([(100, (2, 7), 1)], None)]


def _steps_redelivery():
    return [(None, [(900, (7, "u"), 1), (901, (8, "v"), 1)]),
            ([(100, (1, 7), 1)], None),
            ([(100, (2, 8), 1)], None),
            ([(100, (2, 8), -1)], None)]


def _steps_fuzz(seed=7, n_steps=150):
    rng = np.random.default_rng(seed)
    truth_l: dict = {}
    truth_r: dict = {}
    steps = []
    for _ in range(n_steps):
        ops_l: list = []
        ops_r: list = []
        for _ in range(rng.integers(1, 6)):
            side = rng.random() < 0.6
            tl = truth_l if side else truth_r
            ops = ops_l if side else ops_r
            used = {k for k, _r, _d in ops}
            if tl and rng.random() < 0.45:
                items = [k for k in tl if k not in used]
                if not items:
                    continue
                k = items[int(rng.integers(0, len(items)))]
                ops.append((k, tl.pop(k), -1))
            else:
                k = int(rng.integers(0, 1 << 30)) + (0 if side else 1 << 40)
                if k in tl or k in used:
                    continue
                row = ((k, int(rng.integers(0, 6))) if side
                       else (int(rng.integers(0, 6)), f"n{k}"))
                tl[k] = row
                ops.append((k, row, 1))
        steps.append((ops_l or None, ops_r or None))
    return steps, truth_l, truth_r


@pytest.mark.parametrize("arm", NODE_ARMS)
@pytest.mark.parametrize("case", ["hotkey_delta", "hotkey_one_shot", "reinsert_same_key",
                                  "redelivery_changes_join_key"])
def test_join_node_steps_equal_jax(case, arm):
    steps = {"hotkey_delta": _steps_hotkey, "hotkey_one_shot": _steps_hotkey_once,
             "reinsert_same_key": _steps_reinsert,
             "redelivery_changes_join_key": _steps_redelivery}[case]()
    want = _drive("jax", arm, steps)
    got = _drive("torch", arm, steps)
    assert got == want
    if case == "hotkey_delta":
        # exactly the 64 new pairs a step, never a re-emitted one
        assert all(len(o) == 64 and all(d == 1 for *_x, d in o) for o in got[1:])
        assert len({k for o in got[1:] for k, *_x in o}) == 8 * 64
    if case == "reinsert_same_key":
        assert sorted((r, d) for _k, r, d in got[2]) == [((1, "u"), -1), ((2, "u"), 1)]
    if case == "redelivery_changes_join_key":
        assert sorted((r, d) for _k, r, d in got[2]) == [((1, "u"), -1), ((2, "v"), 1)]
        assert [(r, d) for _k, r, d in got[3]] == [((2, "v"), -1)]


@pytest.mark.parametrize("arm", NODE_ARMS)
def test_join_node_redelivery_state_cleaned(arm):
    node = _node("torch", arm)
    for t, (lr, rr) in enumerate(_steps_redelivery()):
        node.step(t, [_batch("torch", ("oid", "uid"), lr),
                      _batch("torch", ("uid", "name"), rr)])
        if t == 2:
            assert 100 not in node._left.get(7, {})
    assert not node._left_jk


@pytest.mark.parametrize("arm", NODE_ARMS)
def test_join_node_mixed_sign_fuzz_equals_jax_and_batch_truth(arm):
    steps, truth_l, truth_r = _steps_fuzz()
    want = _drive("jax", arm, steps)
    got = _drive("torch", arm, steps)
    assert got == want
    down: dict = {}
    for out in got:
        for k, row, d in out or ():
            down[(k, row)] = down.get((k, row), 0) + d
            if down[(k, row)] == 0:
                del down[(k, row)]
    (once,) = _drive("torch", arm, [([(k, r, 1) for k, r in truth_l.items()] or None,
                                     [(k, r, 1) for k, r in truth_r.items()] or None)])
    assert down == {(k, row): d for k, row, d in once or ()}


@pytest.mark.parametrize("arm", NODE_ARMS)
def test_join_node_cross_join_empty_key_list(arm):
    kw = dict(on=(), left=("a",), right=("b",),
              spec=(("a", "left", "a"), ("b", "right", "b")))
    steps = [(None, [(100 + i, (i,), 1) for i in range(3)]),
             ([(1, ("x",), 1), (2, ("y",), 1)], None)]
    want = _drive("jax", arm, steps, **kw)
    got = _drive("torch", arm, steps, **kw)
    assert got == want
    assert sorted(r for _k, r, _d in got[1]) == [
        ("x", 0), ("x", 1), ("x", 2), ("y", 0), ("y", 1), ("y", 2)]


@pytest.mark.parametrize("mode", ["inner", "left", "right", "outer"])
def test_join_node_native_equals_python_path(mode):
    """The port's C++ loops against its own Python path, each mode, over
    the fuzz stream: equal outputs step by step."""
    steps, _l, _r = _steps_fuzz(seed=11, n_steps=80)
    native = _drive("torch", "native", steps, mode=mode)
    python = _drive("torch", "python", steps, mode=mode)
    assert _drive("jax", "native", steps, mode=mode) == native
    assert _drive("jax", "python", steps, mode=mode) == python
    # the two paths may order a step's rows apart, never its contents
    assert [sorted(o or ()) for o in native] == [sorted(o or ()) for o in python]


def test_native_join_loops_against_python_directly():
    """``join_apply_side`` and ``join_ld_cross`` against the Python loops
    they replace: the same deltas, dirty set and undo log; the same
    columns, pair keys and diffs."""
    from pathway_tpu_torch import native
    from pathway_tpu_torch.engine.value import ERROR, keys_for_value_columns

    rng = np.random.default_rng(3)
    keys = [int(k) for k in rng.integers(0, 1 << 63, size=40, dtype=np.uint64)]
    keys = [k | (1 << 63) if i % 2 else k for i, k in enumerate(keys)]  # big keys too
    jks = [int(x) for x in rng.integers(0, 5, size=40)]
    cols = ([f"v{i}" for i in range(40)], jks)
    diffs = [1] * 40
    cols[1][3] = ERROR
    node = t_join.JoinNode(t_graph.EngineGraph(), t_graph.Node(t_graph.EngineGraph(), [],
                           ["v", "jk"]), t_graph.Node(t_graph.EngineGraph(), [], ["jk", "w"]),
                           ["jk"], ["jk"], "inner", [("v", "left", "v"), ("w", "right", "w")])
    batch = t_batch.Batch.from_rows(["v", "jk"], [(k, (cols[0][i], cols[1][i]), 1)
                                                  for i, k in enumerate(keys)])
    from collections import defaultdict

    py_state, py_k2j = defaultdict(dict), {}
    node.native = False
    py = node._side_deltas(py_state, py_k2j, batch, ["jk"])
    node.native = True
    c_state, c_k2j = {}, {}
    c = node._side_deltas(c_state, c_k2j, batch, ["jk"])
    assert dict(c[0]) == dict(py[0]) and c[1] == py[1] and dict(c[2]) == dict(py[2])
    assert c_state == dict(py_state) and c_k2j == py_k2j
    # the cross product: 3 delta rows against a 4-row bucket, both orientations
    delta = [(keys[i], (f"v{i}", 1), 1 if i % 3 else -1) for i in range(3)]
    bucket = {keys[10 + i]: (1, f"w{i}") for i in range(4)}
    for swapped in (False, True):
        work = (delta, bucket, True) if swapped else (delta, bucket)
        col_lists, kbuf, dbuf = native.join_ld_cross([work], bytes([1, 0]), [0, 1])
        got_keys = np.frombuffer(kbuf, dtype=np.uint64).tolist()
        lks = [dk for dk, _r, _d in delta for _bk in bucket]
        rks = [bk for _dk, _r, _d in delta for bk in bucket]
        if swapped:
            lks, rks = rks, lks
        want_keys = keys_for_value_columns(
            [np.array(lks, dtype=object), np.array(rks, dtype=object)], len(lks)).tolist()
        assert got_keys == want_keys
        assert np.frombuffer(dbuf, dtype=np.int64).tolist() == [
            d for _k, _r, d in delta for _b in bucket]
        lrows = [r for _k, r, _d in delta for _b in bucket]
        brows = [b for _d in delta for b in bucket.values()]
        if swapped:
            assert list(col_lists[0]) == [b[0] for b in brows]
            assert list(col_lists[1]) == [r[1] for r in lrows]
        else:
            assert list(col_lists[0]) == [r[0] for r in lrows]
            assert list(col_lists[1]) == [b[1] for b in brows]
