"""The Table API.

Parity with reference ``python/pathway/internals/table.py`` (Table: select,
filter, groupby/reduce, join family, concat, update_rows/cells,
with_id_from, flatten, difference/intersect/restrict, ix/ix_ref,
pointer_from, deduplicate, ...). Operations eagerly build engine nodes (the
engine graph is lazy; nothing runs until ``pw.run``/debug helpers).

The methods whose operators the port does not carry yet are absent: the
temporal joins and ``windowby``, ``sort``, ``diff``, ``interpolate``, the
temporal behaviours, ``live`` and the gradual broadcast (ROADMAP A13).
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Mapping

import numpy as np

from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.operators import core as core_ops
from pathway_tpu_torch.engine.operators import reduce as reduce_ops
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import expand_star_args, substitute
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    IxExpression,
    PointerExpression,
    ReducerExpression,
)
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.type_interpreter import infer_dtype
from pathway_tpu_torch.internals.universe import Universe, register_equal, register_subset


def _name_seq(prefix: str):
    counter = itertools.count()
    while True:
        yield f"{prefix}{next(counter)}"


class TableLike:
    """Common interface of universe-bearing objects — Table, GroupedTable,
    JoinResult (reference ``internals/table_like.py:15``). Universe promises
    registered here feed the SAT-backed universe solver
    (``internals/universe.py``)."""

    _universe: Any = None

    def promise_universes_are_disjoint(self, other: "TableLike"):
        # disjointness is not used by the solver's subset/equality queries;
        # accepted for API parity (the reference registers it for concat)
        return self

    def promise_universes_are_equal(self, other: "TableLike"):
        from pathway_tpu_torch.internals.universe import register_equal

        register_equal(self._universe, other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "TableLike"):
        from pathway_tpu_torch.internals.universe import register_equal

        register_equal(self._universe, other._universe)
        return self

    def promise_universe_is_subset_of(self, other: "TableLike"):
        from pathway_tpu_torch.internals.universe import register_subset

        register_subset(self._universe, other._universe)
        return self


class Joinable(TableLike):
    """Things you can join on: tables and join results."""

    def join(self, other, *on, id=None, how="inner", left_instance=None, right_instance=None):
        from pathway_tpu_torch.internals.joins import join as join_impl

        return join_impl(
            self, other, *on, id=id, how=how,
            left_instance=left_instance, right_instance=right_instance,
        )

    def join_inner(self, other, *on, **kw):
        return self.join(other, *on, how="inner", **kw)

    def join_left(self, other, *on, **kw):
        return self.join(other, *on, how="left", **kw)

    def join_right(self, other, *on, **kw):
        return self.join(other, *on, how="right", **kw)

    def join_outer(self, other, *on, **kw):
        return self.join(other, *on, how="outer", **kw)


class Table(Joinable):
    """A (possibly streaming) keyed table of rows."""

    def __init__(
        self,
        node: Node,
        schema: schema_mod.SchemaMetaclass,
        universe: Universe | None = None,
    ):
        assert list(schema.column_names()) == list(node.column_names), (
            f"schema/node mismatch: {schema.column_names()} vs {node.column_names}"
        )
        self._node = node
        self._schema = schema
        self._universe = universe if universe is not None else Universe()

    # ------------------------------------------------------------------ basics
    @property
    def schema(self) -> schema_mod.SchemaMetaclass:
        return self._schema

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    def column_names(self) -> list[str]:
        return list(self._schema.column_names())

    def keys(self):
        return self.column_names()

    def __iter__(self):
        for name in self.column_names():
            yield self[name]

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__") or name in ("_node", "_schema", "_universe"):
            raise AttributeError(name)
        schema = object.__getattribute__(self, "_schema")
        if name not in schema.__columns__:
            raise AttributeError(
                f"Table has no column {name!r}; columns: {self.column_names()}"
            )
        return ColumnReference(self, name)

    def __getitem__(self, arg):
        if isinstance(arg, str):
            if arg == "id":
                return self.id
            if arg not in self._schema.__columns__:
                raise KeyError(f"no column {arg!r}")
            return ColumnReference(self, arg)
        if isinstance(arg, ColumnReference):
            return self[arg.name]
        if isinstance(arg, (list, tuple)):
            refs = [self[c] for c in arg]
            return self.select(*refs)
        raise TypeError(f"cannot index Table with {arg!r}")

    def __repr__(self) -> str:
        return f"<pathway_tpu_torch.Table schema={self._schema!r}>"

    def _dtype_of(self, name: str) -> dt.DType:
        if name == "id":
            return dt.Pointer(self._schema)
        return self._schema.__columns__[name].dtype

    typehints = property(lambda self: self._schema.typehints())

    # ------------------------------------------------------------ select et al.
    def _desugar(self, expression):
        expression = substitute(expression, {thisclass.this: self})
        return expression

    def select(self, *args, **kwargs) -> "Table":
        """Project to new columns; keys unchanged."""
        return self._select_impl(args, kwargs, keep_old=False)

    def with_columns(self, *args, **kwargs) -> "Table":
        """Add/replace columns, keeping existing ones."""
        return self._select_impl(args, kwargs, keep_old=True)

    def __add__(self, other) -> "Table":
        """Concatenate the columns of two same-universe tables (reference
        ``Table.__add__``); duplicate column names are rejected."""
        if not isinstance(other, Table):
            return NotImplemented
        dup = set(self.column_names()) & set(other.column_names())
        if dup:
            raise ValueError(
                f"columns {sorted(dup)} appear on both sides of `+`; "
                "rename one side first"
            )
        return self.with_columns(**{n: other[n] for n in other.column_names()})

    def _select_impl(self, args, kwargs, keep_old: bool) -> "Table":
        exprs: dict[str, ColumnExpression] = {}
        args = expand_star_args(args, self)
        for a in args:
            a = self._desugar(a) if isinstance(a, ColumnExpression) else a
            if isinstance(a, ColumnReference):
                exprs[a.name] = a
            elif isinstance(a, ColumnExpression) and getattr(a, "name", None):
                exprs[a.name] = a
            else:
                raise ValueError(
                    f"positional select arguments must be column references, got {a!r}"
                )
        for name, e in kwargs.items():
            exprs[name] = self._desugar(expr_mod.smart_coerce(e))
        if keep_old:
            old = {
                name: ColumnReference(self, name)
                for name in self.column_names()
                if name not in exprs
            }
            exprs = {**old, **exprs}
        return self._build_rowwise(exprs)

    def _build_rowwise(self, exprs: dict[str, ColumnExpression]) -> "Table":
        env_node, rewritten = _prepare_env(self, exprs)
        node = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)
        schema = _infer_schema(self, rewritten)
        return Table(node, schema, self._universe)

    def filter(self, expression) -> "Table":
        expression = self._desugar(expr_mod.smart_coerce(expression))
        env_node, rewritten = _prepare_env(
            self,
            {"__filter__": expression, **{
                n: ColumnReference(self, n) for n in self.column_names()
            }},
        )
        combo = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)
        fnode = core_ops.FilterNode(
            G.engine_graph, combo, ColumnReference(None, "__filter__")
        )
        out = core_ops.SelectColumnsNode(
            G.engine_graph, fnode, {n: n for n in self.column_names()}
        )
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__), name=None
        )
        u = self._universe.subset()
        return Table(out, schema, u)

    def split(self, split_expression) -> tuple["Table", "Table"]:
        """Split into (matching, non-matching) tables with provably-disjoint
        key subsets (reference ``table.py:531-568``)."""
        from pathway_tpu_torch.internals import universe as universe_mod

        expression = expr_mod.smart_coerce(split_expression)
        positive = self.filter(expression)
        negative = self.filter(~expression)
        # filter() already registers each side as a subset of self; record
        # the disjointness promise (reference also concats to assert
        # equality, but that adds an unused node to the graph)
        universe_mod.promise_are_pairwise_disjoint(positive, negative)
        return positive, negative

    def copy(self) -> "Table":
        return self.select(*[self[c] for c in self.column_names()])

    def rename(self, names_mapping: Mapping | None = None, **kwargs) -> "Table":
        mapping: dict[str, str] = {}
        if names_mapping:
            for old, new in names_mapping.items():
                old_name = old.name if isinstance(old, ColumnReference) else old
                new_name = new.name if isinstance(new, ColumnReference) else new
                mapping[old_name] = new_name
        for new, old in kwargs.items():
            old_name = old.name if isinstance(old, ColumnReference) else old
            mapping[old_name] = new
        exprs = {}
        for name in self.column_names():
            exprs[mapping.get(name, name)] = ColumnReference(self, name)
        return self.select(**exprs)

    rename_columns = rename

    def rename_by_dict(self, names_mapping) -> "Table":
        return self.rename(names_mapping)

    def with_prefix(self, prefix: str) -> "Table":
        return self.rename({n: f"{prefix}{n}" for n in self.column_names()})

    def with_suffix(self, suffix: str) -> "Table":
        return self.rename({n: f"{n}{suffix}" for n in self.column_names()})

    def without(self, *columns) -> "Table":
        names = {c.name if isinstance(c, ColumnReference) else c for c in columns}
        keep = [n for n in self.column_names() if n not in names]
        return self.select(*[self[n] for n in keep])

    # ------------------------------------------------------------ typing utils
    def update_types(self, **kwargs) -> "Table":
        schema = self._schema.with_types(**kwargs)
        return Table(self._node, schema, self._universe)

    def cast_to_types(self, **kwargs) -> "Table":
        exprs = {
            n: (
                expr_mod.cast(kwargs[n], self[n]) if n in kwargs else self[n]
            )
            for n in self.column_names()
        }
        return self.select(**exprs)

    # ------------------------------------------------------------------ keys
    def pointer_from(self, *args, optional=False, instance=None) -> PointerExpression:
        return PointerExpression(
            self, *[self._desugar(expr_mod.smart_coerce(a)) for a in args],
            optional=optional,
            instance=self._desugar(expr_mod.smart_coerce(instance)) if instance is not None else None,
        )

    def with_id_from(self, *args, instance=None) -> "Table":
        key_expr = self.pointer_from(*args, instance=instance)
        return self._reindex(key_expr)

    def with_id(self, new_id: ColumnReference) -> "Table":
        return self._reindex(self._desugar(new_id))

    def _reindex(self, key_expr) -> "Table":
        env_node, rewritten = _prepare_env(
            self,
            {
                "__newid__": key_expr,
                **{n: ColumnReference(self, n) for n in self.column_names()},
            },
        )
        combo = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)
        node = core_ops.ReindexNode(
            G.engine_graph, combo, ColumnReference(None, "__newid__")
        )
        out = core_ops.SelectColumnsNode(
            G.engine_graph, node, {n: n for n in self.column_names()}
        )
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__)
        )
        return Table(out, schema, Universe())

    # ------------------------------------------------------------- set algebra
    def concat(self, *others: "Table") -> "Table":
        tables = (self,) + others
        node = core_ops.ConcatNode(G.engine_graph, [t._node for t in tables])
        schema = _merge_schemas(tables)
        u = Universe()
        for t in tables:
            register_subset(t._universe, u)
        return Table(node, schema, u)

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = (self,) + others
        reindexed = [
            t.with_id_from(t.id, i) for i, t in enumerate(tables)
        ]
        return reindexed[0].concat(*reindexed[1:])

    def update_rows(self, other: "Table") -> "Table":
        node = core_ops.UpdateRowsNode(G.engine_graph, self._node, other._node)
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__)
        )
        u = Universe()
        register_subset(self._universe, u)
        register_subset(other._universe, u)
        return Table(node, schema, u)

    def update_cells(self, other: "Table") -> "Table":
        update_cols = [
            c for c in other.column_names() if c in self.column_names()
        ]
        node = core_ops.UpdateCellsNode(
            G.engine_graph, self._node, other._node, update_cols
        )
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__)
        )
        return Table(node, schema, self._universe)

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def difference(self, other: "Table") -> "Table":
        node = core_ops.UniverseOpNode(
            G.engine_graph, [self._node, other._node], "difference"
        )
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__)
        )
        return Table(node, schema, self._universe.subset())

    def intersect(self, *others: "Table") -> "Table":
        node = core_ops.UniverseOpNode(
            G.engine_graph, [self._node] + [o._node for o in others], "intersect"
        )
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__)
        )
        return Table(node, schema, self._universe.subset())

    def having(self, *indexers) -> "Table":
        """Keep rows whose every ``ix_ref`` indexer resolves to an existing
        row of its target table (reference ``Table.having`` /
        ``HavingContext``)."""
        result = self
        for proxy in indexers:
            # probe a constant-true marker column on the target so the test
            # is ROW EXISTENCE — a nullable first column must not matter
            marker = proxy.table.select(__having_probe__=True)
            probe = expr_mod.IxExpression(
                marker, proxy.key_expr, "__having_probe__", optional=True
            )
            result = result.filter(probe.is_not_none())
        return result

    def restrict(self, other: "Table") -> "Table":
        node = core_ops.UniverseOpNode(
            G.engine_graph, [self._node, other._node], "restrict"
        )
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__)
        )
        return Table(node, schema, other._universe)

    def with_universe_of(self, other: "Table") -> "Table":
        register_equal(self._universe, other._universe)
        return Table(self._node, self._schema, other._universe)

    @property
    def slice(self):
        """A manipulable view of this table's column references (reference
        ``Table.slice`` / ``internals/table_slice.py``):
        ``t.select(*t.slice.without("age"))``."""
        from pathway_tpu_torch.internals.table_slice import TableSlice

        return TableSlice({n: self[n] for n in self.column_names()}, self)

    def remove_errors(self) -> "Table":
        """Filter out rows containing ERROR values (reference
        ``Table.remove_errors``, table.py:2491)."""
        node = core_ops.RemoveErrorsNode(G.engine_graph, self._node)
        return Table(node, self._schema, self._universe.subset())

    def to(self, sink) -> None:
        """Send this table to a sink (reference ``Table.to``, table.py:2353
        — ``table.to(datasink)``). Accepts anything exposing
        ``write(table)`` (our ``pw.io.*`` writer objects) or a callable."""
        if hasattr(sink, "write"):
            sink.write(self)
            return
        if callable(sink):
            sink(self)
            return
        raise TypeError(
            f"Table.to expects a sink with .write(table) or a callable, "
            f"got {type(sink).__name__}"
        )

    def eval_type(self, expression):
        """Dtype the type interpreter assigns ``expression`` in this
        table's context (reference ``Table.eval_type``, table.py:2549)."""
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        return infer_dtype(
            self._desugar(expr_mod.smart_coerce(expression)), self
        )

    def update_id_type(self, id_type, *, id_append_only: bool | None = None) -> "Table":
        """Override the dtype of ``self.id`` (reference
        ``Table.update_id_type``, table.py:2003). The override lives on the
        result's universe, so tables DERIVED from the result (filter,
        select, ...) keep the id type; the source table is unchanged."""
        if id_append_only is not None:
            import warnings

            warnings.warn(
                "update_id_type: id_append_only is accepted for reference "
                "API parity but append-only id tracking is not modeled; "
                "the flag has no effect",
                stacklevel=2,
            )
        u = self._universe.subset()
        register_equal(self._universe, u)  # same keys, distinct carrier
        u.id_dtype = dt.wrap(id_type) if not isinstance(id_type, dt.DType) else id_type
        return Table(self._node, self._schema, u)

    def is_subset_of(self, other: "Table") -> bool:
        from pathway_tpu_torch.internals.universe import GLOBAL_SOLVER

        return GLOBAL_SOLVER.query_is_subset(self._universe, other._universe)

    # universe promises (promise_universes_are_equal & co.) inherit from
    # TableLike

    # ------------------------------------------------------------------ lookup
    def ix(self, expression, *, optional: bool = False, context=None):
        return TableIxProxy(self, expression, optional)

    def ix_ref(self, *args, optional: bool = False, instance=None):
        return TableIxProxy(
            self, self.pointer_from(*args, instance=instance), optional
        )

    # --------------------------------------------------------------- group/agg
    def groupby(
        self,
        *args,
        id=None,
        sort_by=None,
        _filter_out_results_of_forgetting=False,
        instance=None,
        _result_cls=None,  # JoinResult.groupby -> GroupedJoinResult
        **kwargs,
    ):
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        grouping = [self._desugar(a) for a in args]
        inst = self._desugar(expr_mod.smart_coerce(instance)) if instance is not None else None
        sort_expr = (
            self._desugar(expr_mod.smart_coerce(sort_by))
            if sort_by is not None
            else None
        )
        cls = _result_cls or GroupedTable
        if id is not None:
            id_ref = self._desugar(id)
            grouping = [id_ref]
            return cls(self, grouping, inst, by_id=True, sort_by=sort_expr)
        return cls(self, grouping, inst, sort_by=sort_expr)

    def reduce(self, *args, **kwargs) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value,
        instance=None,
        acceptor,
        name=None,
    ) -> "Table":
        value = self._desugar(expr_mod.smart_coerce(value))
        inst = (
            self._desugar(expr_mod.smart_coerce(instance))
            if instance is not None
            else expr_mod.ColumnConstExpression(None)
        )
        env_node, rewritten = _prepare_env(
            self,
            {
                "__value__": value,
                "__instance__": inst,
                **{n: ColumnReference(self, n) for n in self.column_names()},
            },
        )
        combo = core_ops.RowwiseNode(G.engine_graph, env_node, rewritten)
        node = reduce_ops.DeduplicateNode(
            G.engine_graph, combo, "__value__", "__instance__", acceptor
        )
        out = core_ops.SelectColumnsNode(
            G.engine_graph, node, {n: n for n in self.column_names()}
        )
        schema = schema_mod.schema_builder_from_definitions(
            dict(self._schema.__columns__)
        )
        return Table(out, schema, Universe())

    # ---------------------------------------------------------------- flatten
    def flatten(self, to_flatten: ColumnReference, *, origin_id: str | None = None) -> "Table":
        to_flatten = self._desugar(to_flatten)
        name = to_flatten.name
        if origin_id is not None and origin_id in self.column_names():
            raise ValueError(
                f"flatten: origin_id {origin_id!r} collides with an existing "
                "column; pick a different name"
            )
        node = core_ops.FlattenNode(
            G.engine_graph, self._node, name, origin_column=origin_id
        )
        cols = dict(self._schema.__columns__)
        inner = cols[name].dtype
        if isinstance(inner, dt.List):
            new_dt = inner.wrapped
        elif isinstance(inner, dt.Tuple):
            new_dt = dt.lub(*inner.args) if inner.args else dt.ANY
        elif inner is dt.STR:
            new_dt = dt.STR
        else:
            new_dt = dt.ANY
        cols[name] = schema_mod.ColumnDefinition(dtype=new_dt, name=name)
        if origin_id is not None:
            cols[origin_id] = schema_mod.ColumnDefinition(
                dtype=dt.Pointer(self._schema), name=origin_id
            )
        schema = schema_mod.schema_builder_from_definitions(cols)
        return Table(node, schema, Universe())

    # ------------------------------------------------------------------ output
    def debug(self, name: str = "debug") -> "Table":
        from pathway_tpu_torch import debug as debug_mod

        return self

    def _repr_html_(self):
        from pathway_tpu_torch.debug import table_to_pandas

        try:
            return table_to_pandas(self)._repr_html_()
        except Exception:
            return repr(self)

    # engine-level: external index query (stdlib.indexing uses this)
    def _external_index_as_of_now(
        self,
        index_factory,
        query_table: "Table",
        *,
        index_column,
        query_column,
        index_filter_data_column=None,
        query_filter_column=None,
        query_responses_limit_column=None,
        res_type=None,
    ) -> "Table":
        from pathway_tpu_torch.engine.operators.external_index import ExternalIndexNode

        idx_env, idx_rw = _prepare_env(
            self,
            {
                "__vec__": self._desugar(expr_mod.smart_coerce(index_column)),
                **(
                    {"__fdata__": self._desugar(expr_mod.smart_coerce(index_filter_data_column))}
                    if index_filter_data_column is not None
                    else {}
                ),
            },
        )
        idx_node = core_ops.RowwiseNode(G.engine_graph, idx_env, idx_rw)
        q_exprs = {
            "__qvec__": query_table._desugar(expr_mod.smart_coerce(query_column)),
        }
        if query_responses_limit_column is not None:
            q_exprs["__limit__"] = query_table._desugar(
                expr_mod.smart_coerce(query_responses_limit_column)
            )
        if query_filter_column is not None:
            q_exprs["__qfilter__"] = query_table._desugar(
                expr_mod.smart_coerce(query_filter_column)
            )
        q_env, q_rw = _prepare_env(query_table, q_exprs)
        # the index answers a query once and drops a retracted query by its
        # key, never reading its vector: a retraction replays the inserted
        # values, so the query's embedding UDF runs once a query (JAX runs
        # it again)
        q_node = core_ops.RowwiseNode(G.engine_graph, q_env, q_rw,
                                      replay_retractions=True)
        node = ExternalIndexNode(
            G.engine_graph,
            idx_node,
            q_node,
            index_factory=index_factory,
            vector_col="__vec__",
            query_vector_col="__qvec__",
            limit_col="__limit__" if query_responses_limit_column is not None else None,
            filter_data_col="__fdata__" if index_filter_data_column is not None else None,
            query_filter_col="__qfilter__" if query_filter_column is not None else None,
        )
        schema = schema_mod.schema_from_types(
            _pw_index_reply=dt.List(dt.ANY_TUPLE)
        )
        return Table(node, schema, query_table._universe)

    # ------------------------------------------------------------------ misc
    @staticmethod
    def empty(**kwargs) -> "Table":
        from pathway_tpu_torch.engine.operators.core import InputNode
        from pathway_tpu_torch.engine.batch import Batch

        schema = schema_mod.schema_from_types(**kwargs)
        node = InputNode(G.engine_graph, list(schema.column_names()), name="Empty")
        G.register_static_source(node, lambda: Batch.empty(schema.column_names()))
        return Table(node, schema, Universe())

    @staticmethod
    def from_columns(*args, **kwargs) -> "Table":
        """Build a table from same-universe column references (reference
        ``Table.from_columns``)."""
        import itertools

        exprs: dict[str, ColumnReference] = {}
        named = itertools.chain(
            ((getattr(a, "name", None), a) for a in args), kwargs.items()
        )
        for name, a in named:
            if not isinstance(a, ColumnReference):
                raise ValueError(
                    f"from_columns takes column references, got {a!r}"
                )
            if name in exprs:
                raise ValueError(
                    f"from_columns: duplicate column name {name!r}"
                )
            exprs[name] = a
        if not exprs:
            raise ValueError("from_columns needs at least one column")
        from pathway_tpu_torch.internals.universe import GLOBAL_SOLVER as solver

        refs = list(exprs.values())
        first = refs[0]
        for other in refs[1:]:
            if other.table._universe is first.table._universe:
                continue
            if not solver.query_are_equal(
                first.table._universe, other.table._universe
            ):
                raise ValueError(
                    "from_columns requires columns from the same universe; "
                    "use with_universe_of / promise_universes_are_equal first"
                )
        return first.table.select(**exprs)

    @staticmethod
    def _from_error_log(log) -> "Table":
        from pathway_tpu_torch.engine.operators.core import InputNode
        from pathway_tpu_torch.engine.batch import Batch
        from pathway_tpu_torch.engine.value import hash_values
        import numpy as np

        schema = schema_mod.schema_from_types(message=str, operator_id=Any)
        node = InputNode(G.engine_graph, ["message", "operator_id"], name="ErrorLog")

        def provider():
            entries = log.entries
            rows = [
                (hash_values(i), (e["message"], e.get("operator")), 1)
                for i, e in enumerate(entries)
            ]
            return Batch.from_rows(["message", "operator_id"], rows)

        G.register_static_source(node, provider)
        return Table(node, schema, Universe())


class TableIxProxy:
    def __init__(self, table: Table, key_expr, optional: bool):
        self.table = table
        self.key_expr = key_expr
        self.optional = optional

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return IxExpression(self.table, self.key_expr, name, self.optional)

    def __getitem__(self, name):
        if isinstance(name, ColumnReference):
            name = name.name
        return IxExpression(self.table, self.key_expr, name, self.optional)


# ---------------------------------------------------------------------------
# environment preparation: same-universe column gathering + ix lowering


def _prepare_env(
    table: Table, exprs: dict[str, ColumnExpression]
) -> tuple[Node, dict[str, ColumnExpression]]:
    """Build an engine node whose batches contain every column the
    expressions reference, rewriting references to environment names.

    Handles: references to other same-universe tables (zipped via FusedNode)
    and IxExpressions (lowered to IxNode gathers whose results join the env).
    """
    # collect referenced tables & ix expressions
    tables: list[Table] = [table]
    ix_specs: list[tuple[Table, Any, bool]] = []  # (target, key_expr, optional)

    def scan(e: ColumnExpression):
        if isinstance(e, ColumnReference):
            t = e._table
            if isinstance(t, Table) and all(t is not x for x in tables):
                tables.append(t)
        if isinstance(e, IxExpression):
            for t2, k2, o2 in ix_specs:
                if t2 is e._ix_table and _expr_eq(k2, e._key_expr):
                    break
            else:
                ix_specs.append((e._ix_table, e._key_expr, e._optional))
            scan(e._key_expr)
            return
        for d in e._deps():
            scan(d)

    for e in exprs.values():
        scan(e)

    simple = len(tables) == 1 and not ix_specs
    if simple:
        rewritten = {
            name: _rewrite(e, {id(table): ""}, [], table) for name, e in exprs.items()
        }
        return table._node, rewritten

    # build fused environment
    inputs = []
    slices = []
    prefix_of: dict[int, str] = {}
    for i, t in enumerate(tables):
        prefix = f"__t{i}__"
        prefix_of[id(t)] = prefix
        inputs.append(t._node)
        slices.append({f"{prefix}{n}": n for n in t._node.column_names})
    ix_nodes = []
    for j, (target, key_expr, optional) in enumerate(ix_specs):
        # compute pointer column on the base table
        sub_env, sub_rw = _prepare_env(table, {"__ptr__": key_expr})
        ptr_node = core_ops.RowwiseNode(G.engine_graph, sub_env, sub_rw)
        ix_node = core_ops.IxNode(
            G.engine_graph, ptr_node, target._node, "__ptr__", optional
        )
        prefix = f"__ix{j}__"
        inputs.append(ix_node)
        slices.append({f"{prefix}{n}": n for n in ix_node.column_names})
        ix_nodes.append((target, key_expr, prefix))
    fused = core_ops.FusedNode(G.engine_graph, inputs, slices)
    rewritten = {
        name: _rewrite(e, prefix_of, ix_nodes, table) for name, e in exprs.items()
    }
    return fused, rewritten


def _expr_eq(a, b) -> bool:
    return a is b or repr(a) == repr(b)


def _rewrite(e: ColumnExpression, prefix_of: dict[int, str], ix_nodes, base: Table):
    """Rewrite table-bound references to env column names (table=None refs)."""
    if isinstance(e, ColumnReference):
        t = e._table
        if t is None:
            return e
        if isinstance(t, Table):
            prefix = prefix_of.get(id(t), "")
            if e._name == "id":
                if prefix == "":
                    return ColumnReference(None, "id")
                # ids of same-universe tables equal the batch keys
                return ColumnReference(None, "id")
            return ColumnReference(None, f"{prefix}{e._name}")
        return e
    if isinstance(e, IxExpression):
        for target, key_expr, prefix in ix_nodes:
            if target is e._ix_table and _expr_eq(key_expr, e._key_expr):
                return ColumnReference(None, f"{prefix}{e._column}")
        raise ValueError("unlowered ix expression")
    return _rewrite_generic(e, prefix_of, ix_nodes, base)


def _rewrite_generic(e, prefix_of, ix_nodes, base):
    return expr_mod.map_child_expressions(
        e, lambda v: _rewrite(v, prefix_of, ix_nodes, base)
    )


def _infer_schema(table: Table, exprs: dict[str, ColumnExpression]):
    defs = {}
    for name, e in exprs.items():
        dtype = infer_dtype(e, table)
        defs[name] = schema_mod.ColumnDefinition(dtype=dtype, name=name)
    return schema_mod.schema_builder_from_definitions(defs)


def _merge_schemas(tables: tuple[Table, ...]):
    names = tables[0].column_names()
    defs = {}
    for n in names:
        dtypes = [t._schema.__columns__[n].dtype for t in tables]
        defs[n] = schema_mod.ColumnDefinition(dtype=dt.lub(*dtypes), name=n)
    return schema_mod.schema_builder_from_definitions(defs)
