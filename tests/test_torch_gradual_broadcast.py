"""The port's ``Table._gradual_broadcast`` held against the JAX package's:
the five cases of ``tests/test_gradual_broadcast.py`` go through both
packages, whose final tables (row ids and values) and subscribe update
streams (row id, row, time, is_addition; in order) must be equal, and the
port's rows must show what the JAX test asserts. The operator holds no
device value, so it runs on the CPU only."""

import pytest

from tests.torch_engine import PACKAGES, PW, final_state, update_stream


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _attaches_value(pw):
    t = _md(pw, """
        a
        1
        2
        """)
    thr = _md(pw, """
        l   | v   | u
        0.0 | 5.0 | 10.0
        """)
    return t._gradual_broadcast(thr, thr.l, thr.v, thr.u)


def _small_move(pw):
    t = _md(pw, """
        a | __time__
        1 | 2
        2 | 2
        """)
    thr = _md(pw, """
        l   | v   | u    | __time__ | __diff__
        0.0 | 5.0 | 10.0 | 2        | 1
        0.0 | 5.0 | 10.0 | 4        | -1
        1.0 | 6.0 | 11.0 | 4        | 1
        """)
    return t._gradual_broadcast(thr, thr.l, thr.v, thr.u)


def _band_escape(pw):
    t = _md(pw, """
        a | __time__
        1 | 2
        """)
    thr = _md(pw, """
        l    | v    | u    | __time__ | __diff__
        0.0  | 5.0  | 10.0 | 2        | 1
        0.0  | 5.0  | 10.0 | 4        | -1
        20.0 | 25.0 | 30.0 | 4        | 1
        """)
    return t._gradual_broadcast(thr, thr.l, thr.v, thr.u)


def _new_rows(pw):
    t = _md(pw, """
        a | __time__
        1 | 2
        2 | 6
        """)
    thr = _md(pw, """
        l    | v    | u    | __time__ | __diff__
        0.0  | 5.0  | 10.0 | 2        | 1
        0.0  | 5.0  | 10.0 | 4        | -1
        2.0  | 7.0  | 12.0 | 4        | 1
        """)
    return t._gradual_broadcast(thr, thr.l, thr.v, thr.u)


def _row_deletion(pw):
    t = _md(pw, """
        a | __time__ | __diff__
        1 | 2        | 1
        2 | 2        | 1
        1 | 4        | -1
        """)
    thr = _md(pw, """
        l   | v   | u
        0.0 | 5.0 | 10.0
        """)
    return t._gradual_broadcast(thr, thr.l, thr.v, thr.u)


def _both(build):
    out = []
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        final = final_state(pkg, build(pw))
        pw.clear_graph()
        stream = update_stream(pkg, build(pw))
        pw.clear_graph()
        out.append((final, stream))
    (jf, js), (tf, ts) = out
    assert tf == jf
    assert ts == js
    return tf, ts


def _by_col(final, col):
    rows, cols = final
    return [r[cols.index(col)] for r in rows.values()]


def test_attaches_value():
    final, _ = _both(_attaches_value)
    assert _by_col(final, "apx_value") == [5.0, 5.0]


def test_small_move_touches_nothing():
    final, stream = _both(_small_move)
    # rows assigned 5.0 at time 2; the band moves to [1, 11] at time 4 and
    # 5.0 is still inside: no update after time 2
    assert [e for e in stream if e[2] > 2] == []
    assert _by_col(final, "apx_value") == [5.0, 5.0]


def test_band_escape_updates_rows():
    final, _ = _both(_band_escape)
    assert _by_col(final, "apx_value") == [25.0]


def test_new_rows_get_current_value():
    final, _ = _both(_new_rows)
    rows, cols = final
    assert {r[cols.index("a")]: r[cols.index("apx_value")] for r in rows.values()} == {
        1: 5.0, 2: 7.0}


def test_row_deletion_retracts():
    final, _ = _both(_row_deletion)
    assert _by_col(final, "a") == [2]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_schema_gains_an_optional_float(pkg):
    pw = PW[pkg]
    pw.clear_graph()
    out = _attaches_value(pw)
    assert list(out.column_names()) == ["a", "apx_value"]
    pw.clear_graph()
