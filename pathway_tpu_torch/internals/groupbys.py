"""GroupedTable — ``table.groupby(...).reduce(...)``.

Parity with reference ``internals/groupbys.py``: grouping by expressions (or
by id), optional ``instance`` colocation, reduce with arbitrary expressions
mixing reducers, grouping columns and scalars.
"""

from __future__ import annotations

import copy
from typing import Any

from pathway_tpu_torch.engine.operators import core as core_ops
from pathway_tpu_torch.engine.operators import reduce as reduce_ops
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import expand_star_args
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.type_interpreter import infer_dtype
from pathway_tpu_torch.internals.universe import Universe


class GroupedTable:
    @classmethod
    def create(
        cls,
        table,
        grouping_columns,
        last_column_is_instance: bool = False,
        set_id: bool = False,
        sort_by=None,
        _filter_out_results_of_forgetting: bool = False,
        _skip_errors: bool = True,
        _is_window: bool = False,
    ) -> "GroupedTable":
        """Mirror of the reference constructor (``GroupedTable.create``,
        groupbys.py:119) for code ported from it; our own windowby path
        builds grouped tables directly. When ``last_column_is_instance``
        the trailing column is BOTH a grouping column (so ``reduce`` may
        reference it, as in the reference) and the instance routing
        column."""
        if _skip_errors is not True or _is_window or _filter_out_results_of_forgetting:
            import warnings

            warnings.warn(
                "GroupedTable.create: _skip_errors/_is_window/"
                "_filter_out_results_of_forgetting are accepted for "
                "reference parity but not modeled here",
                stacklevel=2,
            )
        grouping = list(grouping_columns)
        instance = grouping[-1] if last_column_is_instance else None
        return cls(table, grouping, instance, by_id=set_id, sort_by=sort_by)

    def __init__(self, table, grouping: list, instance=None, by_id: bool = False,
                 sort_by=None):
        from pathway_tpu_torch.internals.table import Table

        self._table = table
        self._grouping = [
            g if isinstance(g, ColumnExpression) else expr_mod.smart_coerce(g)
            for g in grouping
        ]
        self._instance = instance
        self._by_id = by_id
        self._sort_by = sort_by

    def _desugar(self, e):
        from pathway_tpu_torch.internals.desugaring import substitute

        return substitute(e, {thisclass.this: self._table})

    def reduce(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table, _prepare_env

        out_exprs: dict[str, ColumnExpression] = {}
        args = expand_star_args(args, self._table)
        for a in args:
            a = self._desugar(a)
            if isinstance(a, ColumnReference):
                out_exprs[a.name] = a
            else:
                raise ValueError("positional reduce args must be column references")
        for name, e in kwargs.items():
            out_exprs[name] = self._desugar(expr_mod.smart_coerce(e))

        # 1. collect reducer expressions & grouping expressions
        reducer_nodes: list[ReducerExpression] = []

        def collect(e: ColumnExpression):
            if isinstance(e, ReducerExpression):
                reducer_nodes.append(e)
                return
            for d in e._deps():
                collect(d)

        for e in out_exprs.values():
            collect(e)

        # 2. prelude: grouping cols + instance + reducer arg cols
        prelude_exprs: dict[str, ColumnExpression] = {}
        group_col_names: list[str] = []
        for i, g in enumerate(self._grouping):
            gname = f"__g{i}"
            prelude_exprs[gname] = g
            group_col_names.append(gname)
        inst_col = None
        if self._instance is not None:
            inst_col = "__inst"
            prelude_exprs[inst_col] = self._instance
        reducer_specs: list[tuple[str, str, list[str], dict]] = []
        arg_counter = 0
        reducer_out_of: dict[int, str] = {}
        for j, r in enumerate(reducer_nodes):
            out_name = f"__r{j}"
            reducer_out_of[id(r)] = out_name
            arg_cols = []
            for a in r._args:
                cname = f"__a{arg_counter}"
                arg_counter += 1
                prelude_exprs[cname] = a
                arg_cols.append(cname)
            red = r._reducer
            kwargs_r = {k: v for k, v in r._kwargs.items()}
            if red.needs_id or red.needs_order:
                cname = f"__a{arg_counter}"
                arg_counter += 1
                # order-sensitive reducers (tuple) honour groupby(sort_by=...);
                # id-consuming reducers (argmin/argmax) always get the row id
                if red.needs_order and not red.needs_id and self._sort_by is not None:
                    prelude_exprs[cname] = self._sort_by
                    # the user's key must dominate arrival time, not tie-break it
                    kwargs_r["user_order"] = True
                else:
                    prelude_exprs[cname] = ColumnReference(self._table, "id")
                arg_cols.append(cname)
            reducer_specs.append((out_name, red.name, arg_cols, kwargs_r))

        env_node, rewritten = _prepare_env(self._table, prelude_exprs)
        prelude = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)

        # 3. groupby node
        gb = reduce_ops.GroupbyNode(
            G.engine_graph,
            prelude,
            group_col_names,
            reducer_specs,
            instance_col=inst_col,
            key_is_pointer_group_col=self._by_id,
        )

        # 4. postlude: map output expressions over groupby output
        def rewrite_out(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ReducerExpression):
                return ColumnReference(None, reducer_out_of[id(e)])
            for i, g in enumerate(self._grouping):
                if _expr_matches(e, g):
                    return ColumnReference(None, f"__g{i}")
            if isinstance(e, ColumnReference):
                # grouping columns may be referred by name
                for i, g in enumerate(self._grouping):
                    if isinstance(g, ColumnReference) and g.name == e.name:
                        return ColumnReference(None, f"__g{i}")
                raise ValueError(
                    f"column {e.name!r} used in reduce is not a grouping column"
                )
            e = copy.copy(e)
            for attr in ("_left", "_right", "_expr", "_if", "_then", "_else",
                         "_val", "_obj", "_index", "_default", "_replacement"):
                if hasattr(e, attr):
                    v = getattr(e, attr)
                    if isinstance(v, ColumnExpression):
                        setattr(e, attr, rewrite_out(v))
            if hasattr(e, "_args"):
                e._args = tuple(
                    rewrite_out(a) if isinstance(a, ColumnExpression) else a
                    for a in e._args
                )
            return e

        post_exprs = {name: rewrite_out(e) for name, e in out_exprs.items()}
        post = core_ops.RowwiseNode(G.engine_graph, gb, post_exprs)

        # 5. schema
        defs = {}
        for name, orig in out_exprs.items():
            dtype = infer_dtype(orig, self._table)
            defs[name] = schema_mod.ColumnDefinition(dtype=dtype, name=name)
        schema = schema_mod.schema_builder_from_definitions(defs)
        return Table(post, schema, Universe())


def _expr_matches(e: ColumnExpression, g: ColumnExpression) -> bool:
    if e is g:
        return True
    if isinstance(e, ColumnReference) and isinstance(g, ColumnReference):
        return e._table is g._table and e.name == g.name
    return False


class GroupedJoinResult(GroupedTable):
    """Grouping of a join result (reference ``groupbys.py:272``) —
    ``t1.join(t2, ...).groupby(...)``. Behaviorally a GroupedTable over the
    materialized join columns; the distinct type mirrors the reference."""
