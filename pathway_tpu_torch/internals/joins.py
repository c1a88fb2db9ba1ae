"""Join API — ``t1.join(t2, t1.a == t2.b).select(...)``.

Parity with reference ``internals/joins.py``: inner/left/right/outer modes,
``pw.left``/``pw.right`` desugaring, id-preservation via ``id=``, instance
colocation. Lowered to the engine's incremental hash join.
"""

from __future__ import annotations

import types
from typing import Any

from pathway_tpu_torch.engine.operators.join import JoinNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import substitute
from pathway_tpu_torch.internals.expression import (
    ColumnBinaryOpExpression,
    ColumnExpression,
    ColumnReference,
)
from pathway_tpu_torch.internals.parse_graph import G

builtins_id = id  # the join API shadows `id` with its keyword argument
from pathway_tpu_torch.internals.type_interpreter import infer_dtype
from pathway_tpu_torch.internals.universe import Universe


def _result_cls(how: str):
    """The one place the how -> result-class choice lives."""
    return JoinResult if how == "inner" else OuterJoinResult


def join(
    left_table,
    right_table,
    *on,
    id=None,
    how="inner",
    left_instance=None,
    right_instance=None,
):
    if hasattr(how, "value"):
        how = how.value
    return _result_cls(how)(
        left_table, right_table, list(on), id, how, left_instance, right_instance
    )


def join_inner(left_table, right_table, *on, **kw):
    """Free-function forms delegate to the ``Joinable`` methods (reference
    ``internals/joins.py:1163``) so join-mode handling has one home."""
    return left_table.join_inner(right_table, *on, **kw)


def join_left(left_table, right_table, *on, **kw):
    return left_table.join_left(right_table, *on, **kw)


def join_right(left_table, right_table, *on, **kw):
    return left_table.join_right(right_table, *on, **kw)


def join_outer(left_table, right_table, *on, **kw):
    return left_table.join_outer(right_table, *on, **kw)


class JoinResult:
    """Lazy join — materialized by ``select``/``reduce``."""

    # class-level default: construction paths that bypass __init__ (e.g.
    # specialized temporal joins building the object piecemeal) still
    # dealias safely as a no-op; immutable so an in-place mutation can never
    # leak into every JoinResult in the process
    _aliases: Any = types.MappingProxyType({})

    def __init__(self, left, right, on, id_, how, left_instance, right_instance):
        from pathway_tpu_torch.internals.table import Table

        self._left = left
        self._right = right
        self._how = how
        self._id = id_
        left_exprs: list[ColumnExpression] = []
        right_exprs: list[ColumnExpression] = []
        for cond in on:
            if not isinstance(cond, ColumnBinaryOpExpression) or cond._operator != "==":
                raise ValueError(f"join condition must be `left == right`, got {cond!r}")
            lexpr = substitute(cond._left, {thisclass.left: left, thisclass.this: left})
            rexpr = substitute(cond._right, {thisclass.right: right, thisclass.this: right})
            left_exprs.append(self._bind(lexpr, left))
            right_exprs.append(self._bind(rexpr, right))
        if left_instance is not None:
            left_exprs.append(self._bind(substitute(left_instance, {thisclass.this: left}), left))
            right_exprs.append(self._bind(substitute(right_instance, {thisclass.this: right}), right))
        self._left_on = left_exprs
        self._right_on = right_exprs
        # chained joins: original-side tables from earlier links resolve
        # through this map into the materialized base's prefixed columns —
        # {id(table): (table, name -> base column name)}
        self._aliases: dict[int, tuple[Any, Any]] = {}

    @staticmethod
    def _bind(e, table):
        return substitute(e, {thisclass.this: table})

    @staticmethod
    def _demangle(name: str) -> str:
        """Strip (possibly nested) __jl_/__jr_ chain prefixes."""
        while name.startswith(("__jl_", "__jr_")):
            name = name[len("__jl_"):]
        return name

    def _resolve_chain_side(self, name: str) -> str | None:
        """Original-name lookup against the materialized chain base: the
        base's columns carry __jl_/__jr_ prefixes; pw.left.a / pw.this.a on
        a chained join must find them by their ORIGINAL name."""
        for cand in (f"__jl_{name}", f"__jr_{name}"):
            if cand in self._left.column_names():
                return cand
        for col in self._left.column_names():
            if (
                col.startswith(("__jl_", "__jr_"))
                and self._demangle(col) == name
            ):
                return col
        return None

    def _dealias(self, e):
        """Rewrite references to aliased prior-join tables (and pw.left /
        pw.this by original name) into this join's left (base) table
        columns; everything else passes through."""
        if not self._aliases or not isinstance(e, ColumnExpression):
            return e

        def rw(x):
            if isinstance(x, ColumnReference):
                t = x._table
                entry = (
                    self._aliases.get(builtins_id(t)) if t is not None else None
                )
                if entry is not None:
                    return ColumnReference(self._left, entry[1](x._name))
                if t is thisclass.left or t is thisclass.this:
                    if t is thisclass.this and x._name == "id":
                        # pw.this.id = the join RESULT's key on chains too;
                        # _rewrite_sel resolves it to the row key
                        return x
                    resolved = self._resolve_chain_side(x._name)
                    if resolved is not None:
                        return ColumnReference(self._left, resolved)
                return x
            if isinstance(x, ColumnExpression):
                return expr_mod.map_child_expressions(x, rw)
            return x

        return rw(e)

    def _output_columns(self) -> dict[str, ColumnReference]:
        """name -> side reference for 'all columns' materializations
        (filter/reduce/groupby); chained joins demangle the base's
        prefixed columns back to their original names."""
        exprs: dict[str, ColumnReference] = {}
        for n in self._left.column_names():
            if self._aliases and n.startswith(("__jl_", "__jr_")):
                out = self._demangle(n)
                if out == "id":
                    continue  # internal id columns never leak
                if out not in exprs:
                    exprs[out] = ColumnReference(thisclass.left, n)
            else:
                exprs[n] = ColumnReference(thisclass.left, n)
        for n in self._right.column_names():
            if n not in exprs:
                exprs[n] = ColumnReference(thisclass.right, n)
        return exprs

    # ---- chaining: reference JoinResult.join (a JoinResult is joinable) ----
    def join(self, other, *on, id=None, how="inner",  # noqa: A002
             left_instance=None, right_instance=None):
        """Chain another join: this join materializes as the LEFT side;
        references to the original left/right tables in later conditions
        and selects keep resolving through the alias map."""
        if hasattr(how, "value"):
            how = how.value
        base = self._raw_table()
        amap: dict[int, tuple[Any, Any]] = {
            builtins_id(self._left): (
                self._left,
                lambda n: "__jl_id" if n == "id" else f"__jl_{n}",
            ),
            builtins_id(self._right): (
                self._right,
                lambda n: "__jr_id" if n == "id" else f"__jr_{n}",
            ),
        }
        for tid, (tbl, f) in self._aliases.items():
            amap[tid] = (tbl, (lambda g: lambda n: f"__jl_{g(n)}")(f))

        def rw(x):
            if isinstance(x, ColumnReference):
                t = x._table
                entry = amap.get(builtins_id(t)) if t is not None else None
                if entry is not None:
                    return base[entry[1](x._name)]
                if t is thisclass.left or t is thisclass.this:
                    # pw.left/pw.this in a chained ON condition refer to the
                    # chain's left side (= the materialized base) by
                    # ORIGINAL column name
                    for cand in (f"__jl_{x._name}", f"__jr_{x._name}"):
                        if cand in base.column_names():
                            return base[cand]
                    for col in base.column_names():
                        if (
                            col.startswith(("__jl_", "__jr_"))
                            and self._demangle(col) == x._name
                            and x._name != "id"
                        ):
                            return base[col]
                return x
            if isinstance(x, ColumnExpression):
                return expr_mod.map_child_expressions(x, rw)
            return x

        if self._left is self._right:
            # self-join: one table on both sides is ambiguous by object
            # identity — refs must use pw.left/pw.right, so alias nothing
            # and let unknown-table references fail loudly
            amap.pop(builtins_id(self._left), None)
        on2 = [rw(c) for c in on]
        id2 = rw(id) if isinstance(id, ColumnExpression) else id
        li2 = (
            rw(left_instance)
            if isinstance(left_instance, ColumnExpression)
            else left_instance
        )
        ri2 = (
            rw(right_instance)
            if isinstance(right_instance, ColumnExpression)
            else right_instance
        )
        jr = _result_cls(how)(base, other, on2, id2, how, li2, ri2)
        jr._aliases = amap
        return jr

    def join_inner(self, other, *on, **kw):
        return self.join(other, *on, how="inner", **kw)

    def join_left(self, other, *on, **kw):
        return self.join(other, *on, how="left", **kw)

    def join_right(self, other, *on, **kw):
        return self.join(other, *on, how="right", **kw)

    def join_outer(self, other, *on, **kw):
        return self.join(other, *on, how="outer", **kw)

    def _build(self):
        """Create the engine join node producing prefixed columns."""
        from pathway_tpu_torch.internals.table import _prepare_env
        from pathway_tpu_torch.engine.operators.core import RowwiseNode

        left, right = self._left, self._right
        # prelude on each side: all columns + join keys + id
        lexprs = {f"__c_{n}": ColumnReference(left, n) for n in left.column_names()}
        lexprs["__id"] = ColumnReference(left, "id")
        for i, e in enumerate(self._left_on):
            lexprs[f"__jk{i}"] = e
        env, rw = _prepare_env(left, lexprs)
        lprep = RowwiseNode(G.engine_graph, env, rw)

        rexprs = {f"__c_{n}": ColumnReference(right, n) for n in right.column_names()}
        rexprs["__id"] = ColumnReference(right, "id")
        for i, e in enumerate(self._right_on):
            rexprs[f"__jk{i}"] = e
        env, rw = _prepare_env(right, rexprs)
        rprep = RowwiseNode(G.engine_graph, env, rw)

        jk_cols = [f"__jk{i}" for i in range(len(self._left_on))]
        key_mode = "pair"
        if self._id is not None:
            idref = self._id
            if isinstance(idref, ColumnReference):
                if idref._table is self._left or idref._table is thisclass.left:
                    key_mode = "left"
                elif idref._table is self._right or idref._table is thisclass.right:
                    key_mode = "right"
        output_spec = (
            [(f"__l_{n}", "left", f"__c_{n}") for n in left.column_names()]
            + [("__l_id", "left", "__id")]
            + [(f"__r_{n}", "right", f"__c_{n}") for n in right.column_names()]
            + [("__r_id", "right", "__id")]
        )
        node = JoinNode(
            G.engine_graph,
            lprep,
            rprep,
            jk_cols,
            jk_cols,
            self._how,
            output_spec,
            key_mode=key_mode,
        )
        return node

    def _rewrite_sel(self, e):
        """Rewrite pw.left/pw.right/table references to join-output env names."""
        left, right = self._left, self._right

        def rw(e):
            if isinstance(e, ColumnReference):
                t = e._table
                if t is thisclass.left or t is left:
                    return ColumnReference(None, "__l_id" if e._name == "id" else f"__l_{e._name}")
                if t is thisclass.right or t is right:
                    return ColumnReference(None, "__r_id" if e._name == "id" else f"__r_{e._name}")
                if t is thisclass.this:
                    if e._name == "id":
                        # the join RESULT's own key (reference
                        # test_outer_join_id): the evaluator resolves a
                        # bare 'id' reference to the current row key
                        return ColumnReference(None, "id")
                    # unqualified this: resolve against left then right
                    if e._name in left.column_names():
                        return ColumnReference(None, f"__l_{e._name}")
                    if e._name in right.column_names():
                        return ColumnReference(None, f"__r_{e._name}")
                    raise ValueError(f"unknown column {e._name!r} in join select")
                if t is None:
                    return e
                raise ValueError(
                    f"reference to table not part of this join: {e!r}"
                )
            return expr_mod.map_child_expressions(e, rw)

        return rw(e)

    def _expand_select_args(self, args) -> dict[str, ColumnExpression]:
        exprs: dict[str, ColumnExpression] = {}
        left, right = self._left, self._right
        # chained joins: star expansion demangles the base's prefixed
        # columns back to original names (and never leaks internal ids)
        out_cols = self._output_columns() if self._aliases else None
        for a in args:
            if a is thisclass.this or a is thisclass.left or a is thisclass.right:
                # bare pw.this / pw.left / pw.right = all columns of that side
                a = thisclass._StarMarker(a, excluded=())
            if isinstance(a, thisclass._StarMarker):
                src = a.placeholder
                if src is thisclass.left:
                    if out_cols is not None:
                        for n, ref in out_cols.items():
                            if ref._table is thisclass.left and n not in a.excluded:
                                exprs[n] = ref
                    else:
                        for n in left.column_names():
                            if n not in a.excluded:
                                exprs[n] = ColumnReference(thisclass.left, n)
                elif src is thisclass.right:
                    for n in right.column_names():
                        if n not in a.excluded:
                            exprs[n] = ColumnReference(thisclass.right, n)
                else:  # pw.this in a join select: all columns from both
                    if out_cols is not None:
                        for n, ref in out_cols.items():
                            if n not in a.excluded:
                                exprs[n] = ref
                    else:
                        for n in left.column_names():
                            if n not in a.excluded:
                                exprs[n] = ColumnReference(thisclass.left, n)
                        for n in right.column_names():
                            if n not in a.excluded and n not in exprs:
                                exprs[n] = ColumnReference(thisclass.right, n)
            elif isinstance(a, thisclass._WithoutHelper):
                exprs.update(self._expand_select_args(list(a)))
            elif isinstance(a, ColumnReference):
                exprs[a.name] = a
            else:
                raise ValueError(f"bad positional select argument {a!r}")
        return exprs

    def _contains_ix(self, e) -> bool:
        if isinstance(e, expr_mod.IxExpression):
            return True
        return any(
            isinstance(d, ColumnExpression) and self._contains_ix(d)
            for d in e._deps()
        )

    def _raw_table(self):
        """Materialize the join output as a real table with uniquely
        prefixed left/right columns plus both ids — the base for selects
        that need the full table machinery (e.g. ix lowering)."""
        cols: dict[str, ColumnExpression] = {}
        for n in self._left.column_names():
            cols[f"__jl_{n}"] = ColumnReference(thisclass.left, n)
        cols["__jl_id"] = ColumnReference(thisclass.left, "id")
        for n in self._right.column_names():
            cols[f"__jr_{n}"] = ColumnReference(thisclass.right, n)
        cols["__jr_id"] = ColumnReference(thisclass.right, "id")
        return self.select(**cols)

    def _rewrite_to_table(self, e, base):
        """Rewrite join-side references into the raw join table's columns,
        leaving ix targets intact for table-level lowering."""
        left, right = self._left, self._right

        def rw(e):
            if isinstance(e, ColumnReference):
                t = e._table
                if t is thisclass.left or t is left:
                    return base[
                        "__jl_id" if e._name == "id" else f"__jl_{e._name}"
                    ]
                if t is thisclass.right or t is right:
                    return base[
                        "__jr_id" if e._name == "id" else f"__jr_{e._name}"
                    ]
                if t is thisclass.this:
                    if e._name in left.column_names():
                        return base[f"__jl_{e._name}"]
                    if e._name in right.column_names():
                        return base[f"__jr_{e._name}"]
                    raise ValueError(f"unknown column {e._name!r} in join select")
                return e
            return expr_mod.map_child_expressions(e, rw)

        return rw(e)

    def select(self, *args, **kwargs):
        from pathway_tpu_torch.internals.table import Table
        from pathway_tpu_torch.engine.operators.core import RowwiseNode

        exprs = self._expand_select_args(args)
        for name, e in kwargs.items():
            exprs[name] = expr_mod.smart_coerce(e)
        exprs = {n: self._dealias(e) for n, e in exprs.items()}
        if any(self._contains_ix(e) for e in exprs.values()):
            base = self._raw_table()
            return base.select(
                **{n: self._rewrite_to_table(e, base) for n, e in exprs.items()}
            )
        node = self._build()
        rewritten = {n: self._rewrite_sel(e) for n, e in exprs.items()}
        out = RowwiseNode(G.engine_graph, node, rewritten)
        defs = {}
        for name, orig in exprs.items():
            dtype = self._infer_joined(orig)
            defs[name] = schema_mod.ColumnDefinition(dtype=dtype, name=name)
        schema = schema_mod.schema_builder_from_definitions(defs)
        return Table(out, schema, Universe())

    def _infer_joined(self, e) -> dt.DType:
        left, right = self._left, self._right

        def dtype_of(e):
            if isinstance(e, ColumnReference):
                t = e._table
                if t is thisclass.left:
                    t = left
                elif t is thisclass.right:
                    t = right
                if t in (left, right):
                    base = (
                        dt.Pointer(t._schema)
                        if e._name == "id"
                        else t._schema.__columns__[e._name].dtype
                    )
                    # outer joins pad with None
                    if (t is left and self._how in ("right", "outer")) or (
                        t is right and self._how in ("left", "outer")
                    ):
                        return dt.Optional(base)
                    return base
            return None

        d = dtype_of(e)
        if d is not None:
            return d
        return infer_dtype(e, left)

    def filter(self, expression):
        left_cols = {
            n: e
            for n, e in self._output_columns().items()
            if e._table is thisclass.left
        }
        return self.select(
            **left_cols,
            __join_filter__=expression,
        ).filter(ColumnReference(thisclass.this, "__join_filter__")).without(
            "__join_filter__"
        )

    def reduce(self, *args, **kwargs):
        left_cols = {
            n: e
            for n, e in self._output_columns().items()
            if e._table is thisclass.left
        }
        return self.select(**left_cols).reduce(*args, **kwargs)

    def keys(self):
        """Output column names of the join (reference ``JoinResult.keys``,
        joins.py:605)."""
        return list(self._output_columns())

    def groupby(self, *args, **kwargs):
        from pathway_tpu_torch.internals.groupbys import GroupedJoinResult

        full = self.select(**self._output_columns())
        # grouping the materialized join, constructed as the reference's
        # distinct GroupedJoinResult type (groupbys.py:272)
        return full.groupby(*args, _result_cls=GroupedJoinResult, **kwargs)


class OuterJoinResult(JoinResult):
    """Result type of left/right/outer joins (reference ``joins.py``):
    behaviorally identical to JoinResult — the distinct type exists because
    outer modes cannot preserve input ids."""


def groupby(grouped, *args, **kwargs):
    """Free-function form of ``Table.groupby`` / ``JoinResult.groupby``
    (reference ``internals/table.py:2592``)."""
    return grouped.groupby(*args, **kwargs)
