"""The port's sort held against the JAX package's: ``Table.sort`` (its
``SortNode``) and ``pw.indexing.sorting`` (the balanced BST, its root
oracle, prev/next pointers from the tree and the nearest non-None values).
The same tables go through both packages; the final tables (row ids and
values) and the subscribe update streams (in order) must be equal.

The cases are every test of ``tests/test_sorting.py``, ``Table.sort``
with an instance and with retractions, and the sorted-index nodes stepped
with the same batches on both packages."""

import numpy as np
import pytest

from pathway_tpu.engine import batch as j_batch
from pathway_tpu.engine import graph as j_graph
from pathway_tpu.engine.operators import sorted_index as j_sorted
from pathway_tpu_torch.engine import batch as t_batch
from pathway_tpu_torch.engine import graph as t_graph
from pathway_tpu_torch.engine.operators import sorted_index as t_sorted
from tests.torch_engine import PACKAGES, PW, canon, final_state, update_stream

KEYS = """
    key | instance
    3.0 | 0
    1.0 | 0
    2.0 | 0
    5.0 | 1
    4.0 | 1
    """


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _run(pkg, build):
    pw = PW[pkg]
    pw.clear_graph()
    final = final_state(pkg, build(pw))
    pw.clear_graph()
    stream = update_stream(pkg, build(pw))
    pw.clear_graph()
    return final, stream


def p_index(pw):
    return pw.indexing.build_sorted_index(_md(pw, KEYS))["index"]


def p_oracle(pw):
    return pw.indexing.build_sorted_index(_md(pw, KEYS))["oracle"]


def p_sort_from_index(pw):
    t = _md(pw, """
        key
        3.0
        1.0
        4.0
        2.0
        5.0
        """)
    return pw.indexing.sort_from_index(pw.indexing.build_sorted_index(t)["index"])


def p_prev_next_values(pw):
    t = _md(pw, """
        a | v
        1 | 10
        2 |
        3 |
        4 | 40
        """)
    srt = t.sort(pw.this.a)
    ordered = t.select(prev=srt.prev, next=srt.next, value=pw.this.v)
    return pw.indexing.retrieve_prev_next_values(ordered)


def p_prev_next_values_explicit(pw):
    t = _md(pw, """
        a | metric
        1 | 7
        2 |
        """)
    srt = t.sort(pw.this.a)
    ordered = t.select(prev=srt.prev, next=srt.next, metric=pw.this.metric)
    return pw.indexing.retrieve_prev_next_values(ordered, value=ordered.metric)


def p_incremental_index(pw):
    """A streaming insert keeps the BST contract (recompute and diff)."""
    from importlib import import_module

    io_python = import_module(f"{pw.__name__}.io.python")

    class Subject(io_python.ConnectorSubject):
        def run(self):
            for key in [3.0, 1.0, 2.0]:
                self.next(key=key, instance=0)
                self.commit()

    t = io_python.read(Subject(), schema=pw.schema_from_types(key=float, instance=int))
    return pw.indexing.sort_from_index(pw.indexing.build_sorted_index(t)["index"])


def p_sort_instance_retractions(pw):
    t = _md(pw, """
        v  | g | __time__ | __diff__
        30 | a | 2        | 1
        10 | a | 2        | 1
        20 | b | 2        | 1
        20 | a | 4        | 1
        10 | b | 4        | 1
        10 | a | 6        | -1
        5  | a | 6        | 1
        20 | b | 8        | -1
        """)
    return t.sort(t.v, instance=t.g)


def p_sort_ties_and_ix(pw):
    t = _md(pw, """
        v | w | __time__ | __diff__
        2 | a | 2        | 1
        2 | b | 2        | 1
        1 | c | 4        | 1
        2 | a | 6        | -1
        """)
    ptrs = t.sort(t.v)
    return t.select(t.w, nxt=t.ix(ptrs.next, optional=True).w,
                    prv=t.ix(ptrs.prev, optional=True).w)


def p_index_retractions(pw):
    t = _md(pw, """
        key | instance | __time__ | __diff__
        3.0 | 0        | 2        | 1
        1.0 | 0        | 2        | 1
        2.0 | 0        | 4        | 1
        7.0 | 1        | 4        | 1
        1.0 | 0        | 6        | -1
        """)
    return pw.indexing.build_sorted_index(t)["index"]


PROGRAMS = {
    # tests/test_sorting.py
    "build_sorted_index_is_valid_bst": p_index,
    "build_sorted_index_oracle": p_oracle,
    "sort_from_index_inorder": p_sort_from_index,
    "retrieve_prev_next_values_skips_nones": p_prev_next_values,
    "retrieve_prev_next_values_explicit_column": p_prev_next_values_explicit,
    "sorted_index_incremental_update": p_incremental_index,
    # Table.sort beyond them
    "sort_instance_retractions": p_sort_instance_retractions,
    "sort_ties_and_ix": p_sort_ties_and_ix,
    "sorted_index_retractions": p_index_retractions,
}


def _epochs(stream):
    """A connector commits at wall-clock times: each time as its epoch's
    rank in the stream."""
    rank: dict = {}
    return [(k, row, rank.setdefault(tm, len(rank)), add) for k, row, tm, add in stream]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_sort_program_equals_jax(name):
    (j_final, j_stream), (t_final, t_stream) = (_run(pkg, PROGRAMS[name])
                                                for pkg in PACKAGES)
    if name == "sorted_index_incremental_update":
        j_stream, t_stream = _epochs(j_stream), _epochs(t_stream)
    assert t_final[1] == j_final[1]
    assert t_final[0] == j_final[0]
    assert t_stream == j_stream
    assert t_final[0]


def test_sorted_index_contracts_hold_on_the_port():
    """``tests/test_sorting.py``'s own checks, on the port's tables: a valid
    BST a instance with its root in the oracle, an in-order chain, the
    nearest non-None values."""
    pw = PW["torch"]
    pw.clear_graph()
    (rows, cols), _ = _run("torch", p_index)
    ki, li, ri, pi, ii = (cols.index(c) for c in ("key", "left", "right", "parent", "instance"))
    for k, row in rows.items():
        for side, cmp in ((li, lambda a, b: a < b), (ri, lambda a, b: a > b)):
            if row[side] is not None:
                child = rows[row[side][1]]
                assert cmp(child[ki], row[ki]) and child[ii] == row[ii]
                assert child[pi][1] == k
    (oracle, ocols), _ = _run("torch", p_oracle)
    assert {r[ocols.index("instance")] for r in oracle.values()} == {0, 1}
    assert all(rows[r[ocols.index("root")][1]][pi] is None for r in oracle.values())
    (chain, _c), _ = _run("torch", p_sort_from_index)
    assert sum(p is None for p, _n in chain.values()) == 1
    (vals, _c), _ = _run("torch", p_prev_next_values)
    assert sorted(vals.values()) == [(10, 10), (10, 40), (10, 40), (40, 40)]


def test_hash_equals_jax():
    from pathway_tpu.stdlib.indexing import sorting as j_sorting
    from pathway_tpu_torch.stdlib.indexing import sorting as t_sorting

    for v in (0, 1, -5, 2**40, 7.0):
        assert t_sorting.hash(v) == j_sorting.hash(v)


# -------------------------------------------------------------- node level

NODES = {"jax": (j_graph, j_batch, j_sorted), "torch": (t_graph, t_batch, t_sorted)}


def _step_chain(pkg, steps):
    """BuildSortedIndex -> SortFromIndex and -> SortedIndexRoot, stepped
    together over ``steps`` of (key, (value, instance), diff)."""
    g_mod, b_mod, ops = NODES[pkg]
    g = g_mod.EngineGraph()
    src = g_mod.Node(g, [], ["k", "i"], "in")
    index = ops.BuildSortedIndexNode(g, src, "k", "i")
    chain = ops.SortFromIndexNode(g, index)
    root = ops.SortedIndexRootNode(g, index)

    def out(b):
        return None if b is None else [(int(k), tuple(canon(v) for v in row), int(d))
                                       for k, row, d in b.rows()]

    outs = []
    for t, rows in enumerate(steps):
        ib = index.step(t, [b_mod.Batch.from_rows(["k", "i"], rows)])
        outs.append((out(ib), out(chain.step(t, [ib])), out(root.step(t, [ib]))))
    return outs


def test_sorted_index_nodes_step_equal_jax():
    rng = np.random.default_rng(5)
    live: dict = {}
    steps = []
    for _ in range(12):
        rows, before = [], sorted(live)  # a step retracts only older rows
        for _ in range(int(rng.integers(1, 6))):
            old = [k for k in before if k in live]
            if old and rng.random() < 0.3:
                k = old[int(rng.integers(0, len(old)))]
                rows.append((k, live.pop(k), -1))
            else:
                k = int(rng.integers(1, 1 << 40))
                live[k] = (float(rng.integers(0, 50)), int(rng.integers(0, 3)))
                rows.append((k, live[k], 1))
        steps.append(rows)
    want = _step_chain("jax", steps)
    got = _step_chain("torch", steps)
    assert got == want
    assert all(o[0] for o in got)
