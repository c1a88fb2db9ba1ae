"""Placeholder substitution — resolve ``pw.this``/``pw.left``/``pw.right``.

Parity with reference ``internals/desugaring.py``: rewrite an expression tree
replacing placeholder-bound column references with references into concrete
tables, including ``ix`` helpers and star-expansion.
"""

from __future__ import annotations

from typing import Any, Mapping

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
)


def substitute(expression: Any, mapping: Mapping[type, Any]) -> Any:
    """Rewrite expression replacing placeholder tables per ``mapping``."""
    if not isinstance(expression, ColumnExpression):
        return expression
    return _sub(expression, mapping)


def _resolve_table(table, mapping):
    if table in mapping:
        return mapping[table]
    return table


def _sub(e: ColumnExpression, m: Mapping[type, Any]) -> ColumnExpression:
    if isinstance(e, ColumnReference):
        tbl = e._table
        if tbl in m:
            target = m[tbl]
            if e._name == "id":
                return target.id
            return target[e._name]
        return e
    if isinstance(e, expr_mod.ColumnConstExpression):
        return e
    if isinstance(e, expr_mod.ColumnBinaryOpExpression):
        return expr_mod.ColumnBinaryOpExpression(
            _sub(e._left, m), _sub(e._right, m), e._operator
        )
    if isinstance(e, expr_mod.ColumnUnaryOpExpression):
        return expr_mod.ColumnUnaryOpExpression(_sub(e._expr, m), e._operator)
    if isinstance(e, expr_mod.ReducerExpression):
        out = expr_mod.ReducerExpression(e._reducer)
        out._args = tuple(_sub(a, m) for a in e._args)
        out._kwargs = {
            k: (_sub(v, m) if isinstance(v, ColumnExpression) else v)
            for k, v in e._kwargs.items()
        }
        return out
    if isinstance(e, expr_mod.ApplyExpression):
        out = type(e)(
            e._fun,
            e._return_type,
            propagate_none=e._propagate_none,
            deterministic=e._deterministic,
            args=tuple(_sub(a, m) for a in e._args),
            kwargs={k: _sub(v, m) for k, v in e._kwargs.items()},
            max_batch_size=e._max_batch_size,
            batched=e._batched,
            submit=e._submit_fun,
            resolve=e._resolve_fun,
            deferred=e._deferred,
        )
        return out
    if isinstance(e, expr_mod.CastExpression):
        return expr_mod.CastExpression(_sub(e._expr, m), e._target)
    if isinstance(e, expr_mod.ConvertExpression):
        out = expr_mod.ConvertExpression(
            _sub(e._expr, m), e._target, unwrap=e._unwrap
        )
        out._default = _sub(e._default, m)
        return out
    if isinstance(e, expr_mod.DeclareTypeExpression):
        return expr_mod.DeclareTypeExpression(_sub(e._expr, m), e._target)
    if isinstance(e, expr_mod.CoalesceExpression):
        return expr_mod.CoalesceExpression(*[_sub(a, m) for a in e._args])
    if isinstance(e, expr_mod.RequireExpression):
        return expr_mod.RequireExpression(
            _sub(e._val, m), *[_sub(a, m) for a in e._args]
        )
    if isinstance(e, expr_mod.IfElseExpression):
        return expr_mod.IfElseExpression(
            _sub(e._if, m), _sub(e._then, m), _sub(e._else, m)
        )
    if isinstance(e, expr_mod.IsNoneExpression):
        return expr_mod.IsNoneExpression(_sub(e._expr, m))
    if isinstance(e, expr_mod.IsNotNoneExpression):
        return expr_mod.IsNotNoneExpression(_sub(e._expr, m))
    if isinstance(e, expr_mod.PointerExpression):
        tbl = _resolve_table(e._table, m)
        out = expr_mod.PointerExpression(tbl, optional=e._optional)
        out._args = tuple(_sub(a, m) for a in e._args)
        out._instance = _sub(e._instance, m) if e._instance is not None else None
        return out
    if isinstance(e, expr_mod.MakeTupleExpression):
        return expr_mod.MakeTupleExpression(*[_sub(a, m) for a in e._args])
    if isinstance(e, expr_mod.GetExpression):
        out = expr_mod.GetExpression(
            _sub(e._obj, m),
            _sub(e._index, m),
            check_if_exists=e._check_if_exists,
        )
        out._default = _sub(e._default, m)
        return out
    if isinstance(e, expr_mod.MethodCallExpression):
        out = expr_mod.MethodCallExpression(e._method)
        out._args = tuple(_sub(a, m) for a in e._args)
        out._kwargs = dict(e._kwargs)
        out._return_type = e._return_type
        return out
    if isinstance(e, expr_mod.UnwrapExpression):
        return expr_mod.UnwrapExpression(_sub(e._expr, m))
    if isinstance(e, expr_mod.FillErrorExpression):
        return expr_mod.FillErrorExpression(
            _sub(e._expr, m), _sub(e._replacement, m)
        )
    if isinstance(e, expr_mod.IxExpression):
        tbl = _resolve_table(e._ix_table, m)
        return expr_mod.IxExpression(
            tbl, _sub(e._key_expr, m), e._column, e._optional
        )
    return e


def expand_star_args(args: tuple, default_table) -> list:
    """Expand ``*pw.this`` / ``*pw.this.without(...)`` star markers into
    explicit column references of the substituted table."""
    out: list = []
    for a in args:
        if isinstance(a, thisclass._StarMarker):
            tbl = default_table if a.placeholder in (thisclass.this,) else a.placeholder
            if isinstance(tbl, type) and issubclass(tbl, tuple(thisclass.PLACEHOLDERS)):
                raise ValueError("cannot expand placeholder without a table")
            for name in tbl.column_names():
                if name not in a.excluded:
                    out.append(tbl[name])
        elif isinstance(a, thisclass._WithoutHelper):
            out.extend(expand_star_args(tuple(a), default_table))
        else:
            out.append(a)
    return out
