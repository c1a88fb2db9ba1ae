"""Sorted-index stdlib — BST over keys, prev/next retrieval.

API parity with reference ``stdlib/indexing/sorting.py`` (``hash:14``,
``build_sorted_index:92``, ``sort_from_index:137``,
``retrieve_prev_next_values:195`` + the schema vocabulary). The reference
assembles a treap with ``pw.iterate`` over grouped argmin steps; here the
columnar engine backs the same contracts with stateful recompute-and-diff
operators (``engine/operators/sorted_index.py``) — same outputs (balanced
search tree with left/right/parent, per-instance root oracle, in-order
prev/next pointers, nearest non-None values), better per-epoch complexity.
"""

from __future__ import annotations

from typing import Any, Optional, TypedDict

import pathway_tpu_torch.internals.dtype as dt
from pathway_tpu_torch.engine.operators import sorted_index as engine_ops
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.internals.table import Table, _prepare_env
from pathway_tpu_torch.internals.universe import Universe


def hash(val) -> int:  # noqa: A001 — reference exports this name
    """Deterministic i64 fingerprint (reference sorting.py:14)."""
    return hash_values(int(val)) & 0x7FFFFFFFFFFFFFFF


class Hash(Schema):
    hash: int


class Node(Schema):
    pass


class Key(Schema):
    key: float


class LeftRight(Schema):
    left: Optional[Any]
    right: Optional[Any]


class Parent(Schema):
    parent: Optional[Any]


class Candidate(Schema):
    candidate: Any


class Instance(Schema):
    instance: Any


class PrevNext(Schema):
    prev: Optional[Any]
    next: Optional[Any]


class SortedIndex(TypedDict):
    index: Table
    oracle: Table


def _env_node(table: Table, exprs: dict):
    env_node, _rewritten = _prepare_env(table, exprs)
    return env_node


def build_sorted_index(nodes: Table, instance=None) -> SortedIndex:
    """Balanced BST (left/right/parent) over the ``key`` column, one tree per
    ``instance``; plus a per-instance root oracle (reference
    ``build_sorted_index`` sorting.py:92-135)."""
    key_expr = nodes.key
    if instance is None and "instance" in nodes._schema.column_names():
        instance = nodes.instance
    exprs = {"__key__": key_expr}
    inst_col = None
    if instance is not None:
        exprs["__instance__"] = instance
        inst_col = "__instance__"
    env_node, rewritten = _prepare_env(nodes, exprs)
    from pathway_tpu_torch.engine.operators import core as core_ops

    combo = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)
    index_node = engine_ops.BuildSortedIndexNode(
        G.engine_graph, combo, "__key__", inst_col
    )
    ptr_t = dt.Optional(dt.Pointer(None))
    index_schema = schema_mod.schema_from_types(
        key=dt.ANY, left=ptr_t, right=ptr_t, parent=ptr_t, instance=dt.ANY
    )
    index = Table(index_node, index_schema, nodes._universe)
    root_node = engine_ops.SortedIndexRootNode(G.engine_graph, index_node)
    oracle_schema = schema_mod.schema_from_types(
        instance=dt.ANY, root=dt.Pointer(None)
    )
    oracle = Table(root_node, oracle_schema, Universe())
    return dict(index=index, oracle=oracle)


def sort_from_index(index: Table, oracle=None) -> Table:
    """Tree (left/right/parent) → in-order prev/next pointers (reference
    ``sort_from_index`` sorting.py:137-170)."""
    env_node, rewritten = _prepare_env(
        index,
        {"left": index.left, "right": index.right, "parent": index.parent},
    )
    from pathway_tpu_torch.engine.operators import core as core_ops

    combo = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)
    node = engine_ops.SortFromIndexNode(G.engine_graph, combo)
    ptr_t = dt.Optional(dt.Pointer(None))
    schema = schema_mod.schema_from_types(prev=ptr_t, next=ptr_t)
    return Table(node, schema, index._universe)


def retrieve_prev_next_values(ordered_table: Table, value=None) -> Table:
    """For each row, nearest non-None ``value`` walking backward (prev_value)
    and forward (next_value) along prev/next chains; a row's own value counts
    first (reference ``retrieve_prev_next_values`` sorting.py:195-230)."""
    if value is None:
        value = ordered_table.value
    env_node, rewritten = _prepare_env(
        ordered_table,
        {
            "prev": ordered_table.prev,
            "next": ordered_table.next,
            "value": expr_mod.smart_coerce(value),
        },
    )
    from pathway_tpu_torch.engine.operators import core as core_ops

    combo = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)
    node = engine_ops.RetrievePrevNextValuesNode(G.engine_graph, combo)
    schema = schema_mod.schema_from_types(prev_value=dt.ANY, next_value=dt.ANY)
    return Table(node, schema, ordered_table._universe)
