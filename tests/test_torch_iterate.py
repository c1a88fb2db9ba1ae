"""The port's ``pw.iterate`` / ``pw.iterate_universe`` held against the JAX
package's, program by program: the same tables go through both packages;
the final tables (row ids and values) and the subscribe update streams
(row id, row, time, is_addition; in order) must be equal.

The cases are every test of ``tests/test_universe_iterate.py`` (the
universe operators beside iterate included), the iterate cases of
``tests/test_reference_behaviors.py``, ``tests/test_stdlib_breadth.py`` and
``tests/test_misc_final_matrix.py``, ``tests/test_multiworker_rerun.py``'s
iterate at two threads, and a few more: a body that builds a static table
of its own, a streaming input that changes over epochs, a multi-table
iterate read through both outputs, and a deferred UDF inside a body (the
nested scheduler keeps UDFs on the blocking path)."""

import pytest

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from tests.torch_engine import PACKAGES, PW, engine_flags, final_state, update_stream


def _run(pkg, build, monkeypatch, **flags):
    pw = PW[pkg]
    with monkeypatch.context() as mp:
        cfg = engine_flags(pkg, mp, **flags)
        pw.clear_graph()
        final = final_state(pkg, build(pw), cfg)
        pw.clear_graph()
        stream = update_stream(pkg, build(pw), cfg)
        pw.clear_graph()
    return final, stream


def _both(build, monkeypatch, **flags):
    """JAX's and the port's (final table, update stream) of ``build``,
    which must be equal; returns the port's final rows."""
    (jf, js), (tf, ts) = (_run(pkg, build, monkeypatch, **flags) for pkg in PACKAGES)
    assert tf == jf
    assert ts == js
    return tf


def _values(final):
    rows, cols = final
    return sorted(rows.values()), cols


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _out(res):
    """The one output of an iterate, whatever shape it came back in."""
    return res.t if hasattr(res, "t") else res


# ------------------------------------------- tests/test_universe_iterate.py
def _update_cells_disjoint(pw):
    base = _md(pw, """
          | a
        1 | 10
        """)
    upd = _md(pw, """
          | a
        9 | 99
        """)
    return base.update_cells(upd.promise_universe_is_subset_of(base))


def _update_cells_partial(pw):
    base = _md(pw, """
          | a  | b
        1 | 10 | x
        2 | 20 | y
        """)
    upd = _md(pw, """
          | a
        2 | 99
        """)
    return base.update_cells(upd.promise_universe_is_subset_of(base))


def _update_rows_adds(pw):
    base = _md(pw, """
          | a
        1 | 10
        """)
    upd = _md(pw, """
          | a
        1 | 11
        5 | 50
        """)
    return base.update_rows(upd)


def _with_universe_of(pw):
    base = _md(pw, """
          | a
        1 | 10
        2 | 20
        """)
    other = _md(pw, """
          | b
        1 | x
        2 | y
        """)
    return other.with_universe_of(base)


def _restrict_subset(pw):
    base = _md(pw, """
          | a
        1 | 10
        2 | 20
        3 | 30
        """)
    small = _md(pw, """
          | z
        1 | p
        3 | q
        """)
    return base.restrict(small.promise_universe_is_subset_of(base))


def _intersect(pw):
    t1 = _md(pw, """
          | a
        1 | 10
        2 | 20
        """)
    t2 = _md(pw, """
          | b
        2 | x
        3 | y
        """)
    return t1.intersect(t2)


def _difference(pw):
    t1 = _md(pw, """
          | a
        1 | 10
        2 | 20
        """)
    t2 = _md(pw, """
          | b
        2 | x
        3 | y
        """)
    return t1.difference(t2)


def _concat_reindex(pw):
    return _md(pw, """
        a
        1
        """).concat_reindex(_md(pw, """
        a
        2
        """))


def _collatz(pw):
    def logic(t):
        return t.select(n=pw.if_else(
            t.n == 1, t.n, pw.if_else(t.n % 2 == 0, t.n // 2, 3 * t.n + 1)))

    t = _md(pw, """
        n
        7
        12
        1
        """)
    return _out(pw.iterate(logic, t=t))


def _limit(pw):
    def logic(t):
        return t.select(n=t.n + 1)

    return _out(pw.iterate(logic, iteration_limit=3, t=_md(pw, """
        n
        0
        """)))


def _shrink(pw):
    def logic(t):
        m = t.reduce(m=pw.reducers.max(t.n))
        joined = t.join(m, t.n == m.m).select(t.n)
        return joined.with_id_from(joined.n)

    t0 = _md(pw, """
        n
        1
        5
        3
        """)
    return _out(pw.iterate(logic, t=t0.with_id_from(t0.n)))


def _two_tables(pw, which):
    def logic(a, b):
        na = a.select(v=pw.if_else(a.v < 10, a.v + 1, a.v))
        nb = b.select(v=pw.if_else(b.v > 0, b.v - 1, b.v))
        return dict(a=na, b=nb)

    a0 = _md(pw, """
        v
        7
        """)
    b0 = _md(pw, """
        v
        2
        """)
    return getattr(pw.iterate(logic, a=a0, b=b0), which)


def _flatten(pw):
    t = _md(pw, """
        k | n
        a | 2
        b | 1
        """)
    t2 = t.select(t.k, parts=pw.apply_with_type(lambda n: tuple(range(n)), tuple, t.n))
    return t2.flatten(t2.parts)


def _groupby_after_reindex(pw):
    t = _md(pw, """
        g | v
        a | 1
        a | 2
        b | 3
        """)
    re = t.with_id_from(t.g, t.v)
    return re.groupby(re.g).reduce(re.g, s=pw.reducers.sum(re.v))


# ------------------------------------------------- the other JAX test files
def _limit_dict_shape(pw):
    # tests/test_reference_behaviors.py: a dict return keeps the namespace
    def step(tab):
        return dict(tab=tab.select(v=pw.if_else(tab.v < 10, tab.v * 2, tab.v)))

    return pw.iterate(step, iteration_limit=2, tab=_md(pw, """
        v
        1
        3
        """)).tab


def _bare_shape(pw):
    # ... and a bare-table return stays bare
    def bare(tab):
        return tab.select(v=pw.if_else(tab.v < 10, tab.v * 2, tab.v))

    out = pw.iterate(bare, tab=_md(pw, """
        v
        1
        """))
    assert isinstance(out, pw.Table)
    return out


def _universe_growth(pw):
    # tests/test_misc_final_matrix.py: iterate_universe over a growing id set
    def logic(t):
        nxt = t.select(n=pw.if_else(t.n < 8, t.n * 2, t.n))
        return nxt.with_id_from(nxt.n)

    t0 = _md(pw, """
        n
        1
        """)
    return _out(pw.iterate_universe(logic, t=t0.with_id_from(t0.n)))


def _threads_case(pw):
    # tests/test_multiworker_rerun.py (run at threads=2 below)
    def logic(t):
        return t.select(n=pw.if_else(t.n >= 5, t.n, t.n + 1))

    return _out(pw.iterate(logic, t=_md(pw, """
        n
        1
        5
        """)))


# --------------------------------------------------------------- more cases
def _static_in_body(pw):
    # a static table built inside the body is fed each round
    def logic(t):
        cap = pw.debug.table_from_markdown("""
            c
            20
            """)
        m = cap.reduce(c=pw.reducers.max(cap.c))
        j = t.join(m).select(n=pw.if_else(t.n + 3 < m.c, t.n + 3, t.n))
        return j.with_id_from(pw.this.n)

    t0 = _md(pw, """
        n
        1
        2
        """)
    return _out(pw.iterate(logic, t=t0.with_id_from(t0.n)))


def _streaming_relax(pw):
    # shortest paths whose edges arrive and leave over epochs: the fixpoint
    # is recomputed and its delta emitted each epoch the edges change
    edges = _md(pw, """
        u | v | w   | __time__ | __diff__
        0 | 1 | 1.0 | 2        | 1
        1 | 2 | 1.0 | 2        | 1
        0 | 2 | 5.0 | 2        | 1
        2 | 3 | 1.0 | 4        | 1
        1 | 2 | 1.0 | 6        | -1
        """)
    verts = edges.select(n=edges.u).concat_reindex(edges.select(n=edges.v))
    dist0 = verts.groupby(verts.n).reduce(verts.n, d=pw.if_else(verts.n == 0, 0.0, 1e18))

    def relax(dist, edges):
        cand = dist.join(edges, dist.n == edges.u).select(n=edges.v, d=dist.d + edges.w)
        both = dist.select(dist.n, dist.d).concat_reindex(cand)
        nd = both.groupby(both.n).reduce(both.n, d=pw.reducers.min(both.d))
        return dict(dist=nd, edges=edges)

    return pw.iterate(relax, dist=dist0, edges=edges).dist


def _halve_udf(pw):
    class Halve(pw.UDF):
        def __init__(self):
            super().__init__(deterministic=True, batch=True, max_batch_size=2,
                             executor=pw.udfs.fully_async_executor())

        def __wrapped__(self, xs):
            return [x // 2 for x in xs]

        def submit_batch(self, xs):
            return list(xs)

        def resolve_batch(self, handles):
            return [[x // 2 for x in h] for h in handles]

    return Halve()


def _deferred_udf_in_body(pw):
    halve = _halve_udf(pw)

    def logic(t):
        return t.select(n=pw.if_else(t.n > 3, halve(t.n), t.n))

    return _out(pw.iterate(logic, t=_md(pw, """
        n
        40
        9
        2
        """)))


PROGRAMS = {
    "update_cells_disjoint": _update_cells_disjoint,
    "update_cells_partial": _update_cells_partial,
    "update_rows_adds": _update_rows_adds,
    "with_universe_of": _with_universe_of,
    "restrict_subset": _restrict_subset,
    "intersect": _intersect,
    "difference": _difference,
    "concat_reindex": _concat_reindex,
    "collatz": _collatz,
    "limit": _limit,
    "shrink": _shrink,
    "two_tables_a": lambda pw: _two_tables(pw, "a"),
    "two_tables_b": lambda pw: _two_tables(pw, "b"),
    "flatten": _flatten,
    "groupby_after_reindex": _groupby_after_reindex,
    "limit_dict_shape": _limit_dict_shape,
    "bare_shape": _bare_shape,
    "universe_growth": _universe_growth,
    "static_in_body": _static_in_body,
    "streaming_relax": _streaming_relax,
}

# what the JAX tests assert of each iterate case, checked on the port's rows
EXPECT = {
    "collatz": [(1,), (1,), (1,)],
    "limit": [(3,)],
    "shrink": [(5,)],
    "two_tables_a": [(10,)],
    "two_tables_b": [(0,)],
    "limit_dict_shape": [(4,), (12,)],
    "bare_shape": [(16,)],
    "universe_growth": [(8,)],
    "static_in_body": [(17,), (19,)],
    "streaming_relax": [(0, 0.0), (1, 1.0), (2, 5.0), (3, 6.0)],
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_equals_jax(name, monkeypatch):
    final = _both(PROGRAMS[name], monkeypatch)
    if name in EXPECT:
        assert _values(final)[0] == EXPECT[name]


@pytest.mark.parametrize("threads", [1, 2])
def test_iterate_threads_equals_jax(threads, monkeypatch):
    final = _both(_threads_case, monkeypatch, threads=threads)
    assert _values(final)[0] == [(5,), (5,)]


@pytest.mark.parametrize("fusion", [True, False])
def test_streaming_iterate_fusion_on_and_off(fusion, monkeypatch):
    _both(_streaming_relax, monkeypatch, fusion=fusion)


def test_deferred_udf_in_body_runs_blocking(monkeypatch):
    final = _both(_deferred_udf_in_body, monkeypatch)
    assert _values(final)[0] == [(2,), (2,), (2,)]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_iterate_outer_table_reference_raises(pkg):
    pw = PW[pkg]
    pw.clear_graph()
    t = _md(pw, """
        n
        1
        """)
    outer = _md(pw, """
        m
        5
        """)

    def body(t):
        return t.join(outer, t.n == outer.m).select(n=t.n)

    with pytest.raises(ValueError, match="outer table"):
        pw.iterate(body, t=t)
    pw.clear_graph()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_iteration_limit_must_be_an_int(pkg):
    pw = PW[pkg]
    pw.clear_graph()
    t = _md(pw, """
        n
        1
        """)
    with pytest.raises(TypeError, match="iteration_limit"):
        pw.iterate(lambda t: t, t, t=t)
    pw.clear_graph()


def test_single_table_body_for_two_tables_raises():
    for pw in (JPW, TPW):
        pw.clear_graph()
        a = _md(pw, """
            v
            1
            """)
        with pytest.raises(ValueError, match="single table"):
            pw.iterate(lambda a, b: a, a=a, b=a)
        pw.clear_graph()


def test_sibling_output_reads_the_primary_fixpoint(monkeypatch):
    """A multi-table iterate runs one fixpoint an epoch: both outputs come
    from the primary node, and the sibling is never skipped by sparse
    stepping."""
    from pathway_tpu_torch.internals import iterate as t_iterate

    TPW.clear_graph()
    a = _two_tables(TPW, "a")
    b = _two_tables(TPW, "b")
    assert isinstance(a._node, t_iterate.IterateNode)
    assert isinstance(b._node, t_iterate.IterateSiblingNode)
    assert b._node.always_step and not a._node.always_step
    TPW.clear_graph()
