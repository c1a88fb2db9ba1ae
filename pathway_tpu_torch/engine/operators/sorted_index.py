"""Sorted-index operators: BST build, tree→prev/next, nearest-value walk.

The engine backing of ``stdlib/indexing/sorting.py``. The reference builds a
treap *inside* the dataflow with ``pw.iterate`` over grouped argmin steps
(``stdlib/indexing/sorting.py:53-135``) because its per-row engine makes
whole-table recomputes expensive; this engine is columnar/epoch-synchronous,
so the idiomatic equivalent is a stateful operator that re-derives the
structure for affected instances per epoch and emits the delta — same output
contract (left/right/parent tree, prev/next pointers, nearest non-None
values), O(n log n) per epoch instead of O(n · depth) dataflow iterations.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.operators.core import StatefulNode, diff_tables
from pathway_tpu_torch.engine.value import Pointer, hash_values


class RecomputeNode(StatefulNode):
    """Materialize input; on change, recompute the whole output and diff.

    Subclasses implement ``compute(rows) -> {key: out_tuple}``.
    """


    def __init__(self, graph, input_node, out_cols, name=""):
        super().__init__(graph, [input_node], out_cols, name)
        self._emitted: dict[int, tuple] = {}

    def reset(self):
        super().reset()
        self._emitted = {}

    def compute(self, rows: dict[int, tuple]) -> dict[int, tuple]:
        raise NotImplementedError

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        self._in_states[0].apply(batch)
        new = self.compute(self._in_states[0].rows)
        out = diff_tables(self._emitted, new, self.column_names)
        self._emitted = new
        return out


def _balanced_bst(entries: list[tuple[Any, int]]) -> dict[int, tuple]:
    """entries: sorted (sort_value, key). Returns key -> (left, right, parent)
    pointers (or None) of a rank-balanced BST — deterministic, depth ⌈log2 n⌉."""
    out: dict[int, list] = {k: [None, None, None] for _, k in entries}

    def build(lo: int, hi: int, parent: int | None) -> int | None:
        if lo > hi:
            return None
        mid = (lo + hi) // 2
        k = entries[mid][1]
        out[k][2] = Pointer(parent) if parent is not None else None
        left = build(lo, mid - 1, k)
        right = build(mid + 1, hi, k)
        out[k][0] = Pointer(left) if left is not None else None
        out[k][1] = Pointer(right) if right is not None else None
        return k

    # iterative-friendly depth: rank-balanced tree depth is log2(n); python
    # recursion is fine for any realistic table (depth 40 ≈ 10^12 rows)
    build(0, len(entries) - 1, None)
    return {k: tuple(v) for k, v in out.items()}


class BuildSortedIndexNode(RecomputeNode):
    """key+instance → (key, left, right, parent, instance) balanced BST rows.

    Output contract of reference ``build_sorted_index`` (sorting.py:92-135).
    """

    def __init__(self, graph, input_node, key_col: str, instance_col: str | None,
                 name="BuildSortedIndex"):
        super().__init__(
            graph, input_node, ["key", "left", "right", "parent", "instance"], name
        )
        self.key_col = key_col
        self.instance_col = instance_col

    def compute(self, rows):
        names = self.inputs[0].column_names
        ki = names.index(self.key_col)
        ii = names.index(self.instance_col) if self.instance_col else None
        by_inst: dict[Any, list] = {}
        for k, row in rows.items():
            inst = row[ii] if ii is not None else None
            by_inst.setdefault(inst, []).append((row[ki], k))
        out: dict[int, tuple] = {}
        for inst, entries in by_inst.items():
            entries.sort(key=lambda t: (t[0], t[1]))
            tree = _balanced_bst(entries)
            keys = {k: sv for sv, k in entries}
            for k, (left, right, parent) in tree.items():
                out[k] = (keys[k], left, right, parent, inst)
        return out


class SortedIndexRootNode(RecomputeNode):
    """Per-instance root oracle (rows keyed by instance hash):
    (instance, root) — reference ``SortedIndex['oracle']``."""

    def __init__(self, graph, index_node, name="SortedIndexRoot"):
        super().__init__(graph, index_node, ["instance", "root"], name)

    def compute(self, rows):
        names = self.inputs[0].column_names
        pi = names.index("parent")
        ii = names.index("instance")
        out: dict[int, tuple] = {}
        for k, row in rows.items():
            if row[pi] is None:
                out[hash_values(row[ii])] = (row[ii], Pointer(k))
        return out


class SortFromIndexNode(RecomputeNode):
    """left/right/parent tree → (prev, next) via in-order traversal — output
    contract of reference ``sort_from_index`` (sorting.py:137-170)."""

    def __init__(self, graph, index_node, name="SortFromIndex"):
        super().__init__(graph, index_node, ["prev", "next"], name)

    def compute(self, rows):
        names = self.inputs[0].column_names
        li, ri, pi = names.index("left"), names.index("right"), names.index("parent")
        roots = [k for k, row in rows.items() if row[pi] is None]
        out: dict[int, tuple] = {}
        for root in roots:
            order: list[int] = []
            # explicit-stack in-order traversal (user-supplied trees may be
            # degenerate chains; no recursion-depth limit)
            stack: list[tuple[int, bool]] = [(root, False)]
            while stack:
                k, expanded = stack.pop()
                if k is None:
                    continue
                row = rows.get(k)
                if row is None:
                    continue
                if expanded:
                    order.append(k)
                    continue
                right = row[ri].value if row[ri] is not None else None
                left = row[li].value if row[li] is not None else None
                if right is not None:
                    stack.append((right, False))
                stack.append((k, True))
                if left is not None:
                    stack.append((left, False))
            for i, k in enumerate(order):
                out[k] = (
                    Pointer(order[i - 1]) if i > 0 else None,
                    Pointer(order[i + 1]) if i + 1 < len(order) else None,
                )
        return out


class RetrievePrevNextValuesNode(RecomputeNode):
    """prev/next/value → (prev_value, next_value): nearest non-None value
    along the chain, own value counting first — contract of reference
    ``retrieve_prev_next_values`` (sorting.py:195-230)."""

    def __init__(self, graph, input_node, name="RetrievePrevNext"):
        super().__init__(graph, input_node, ["prev_value", "next_value"], name)

    def compute(self, rows):
        names = self.inputs[0].column_names
        pi, ni, vi = names.index("prev"), names.index("next"), names.index("value")
        heads = [
            k for k, row in rows.items()
            if row[pi] is None or row[pi].value not in rows
        ]
        out: dict[int, tuple] = {}
        for head in heads:
            chain: list[int] = []
            k: int | None = head
            seen = set()
            while k is not None and k in rows and k not in seen:
                seen.add(k)
                chain.append(k)
                nxt = rows[k][ni]
                k = nxt.value if nxt is not None else None
            last = None
            fwd: list[Any] = []
            for k in chain:
                v = rows[k][vi]
                if v is not None:
                    last = v
                fwd.append(last)
            last = None
            bwd: list[Any] = [None] * len(chain)
            for i in range(len(chain) - 1, -1, -1):
                v = rows[chain[i]][vi]
                if v is not None:
                    last = v
                bwd[i] = last
            for i, k in enumerate(chain):
                out[k] = (fwd[i], bwd[i])
        return out
