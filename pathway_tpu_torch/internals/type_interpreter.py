"""Expression dtype inference.

Parity with reference ``internals/type_interpreter.py`` (simplified): infers
output dtypes of expression trees for schema propagation. Unknown combinations
degrade to ANY rather than erroring — runtime values carry ground truth.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod

_ARITH = {"+", "-", "*", "/", "//", "%", "**", "@", "<<", ">>"}
_CMP = {"==", "!=", "<", "<=", ">", ">="}
_BOOLOP = {"&", "|", "^"}


def infer_dtype(e: expr_mod.ColumnExpression, table) -> dt.DType:
    try:
        return _infer(e, table)
    except Exception:
        return dt.ANY


def _col_dtype(e: expr_mod.ColumnReference, table) -> dt.DType:
    t = e._table
    if t is None or not hasattr(t, "_schema"):
        t = table
    if e._name == "id":
        # Table.update_id_type override rides the universe (and its subsets)
        u = getattr(t, "_universe", None)
        override = getattr(u, "id_dtype", None)
        if override is not None:
            return override
        return dt.Pointer(getattr(t, "_schema", None))
    try:
        return t._schema.__columns__[e._name].dtype
    except Exception:
        return dt.ANY


def _infer(e, table) -> dt.DType:
    if isinstance(e, expr_mod.ColumnReference):
        return _col_dtype(e, table)
    if isinstance(e, expr_mod.ColumnConstExpression):
        return dt.dtype_of_value(e._value)
    if isinstance(e, expr_mod.ColumnBinaryOpExpression):
        lt = _infer(e._left, table)
        rt = _infer(e._right, table)
        op = e._operator
        if op in _CMP:
            return dt.BOOL
        if op in _BOOLOP:
            if lt is dt.BOOL and rt is dt.BOOL:
                return dt.BOOL
            return dt.lub(lt, rt) if lt is rt else dt.ANY
        if op == "/":
            if lt in (dt.INT, dt.FLOAT) and rt in (dt.INT, dt.FLOAT):
                return dt.FLOAT
        if op in _ARITH:
            if lt is dt.STR and rt is dt.STR and op == "+":
                return dt.STR
            if lt is dt.STR and op == "*":
                return dt.STR
            if lt in (dt.INT, dt.FLOAT) and rt in (dt.INT, dt.FLOAT):
                if op == "//" and lt is dt.INT and rt is dt.INT:
                    return dt.INT
                return dt.lub(lt, rt)
            if lt is dt.DATE_TIME_NAIVE and rt is dt.DATE_TIME_NAIVE and op == "-":
                return dt.DURATION
            if lt is dt.DATE_TIME_UTC and rt is dt.DATE_TIME_UTC and op == "-":
                return dt.DURATION
            if lt is dt.DURATION and rt is dt.DURATION:
                if op in ("+", "-"):
                    return dt.DURATION
                if op == "/":
                    return dt.FLOAT
            if lt in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC) and rt is dt.DURATION:
                return lt
            if lt is dt.DURATION and rt in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
                return rt
            if lt is dt.DURATION and rt in (dt.INT, dt.FLOAT):
                return dt.DURATION
            if isinstance(lt, dt.Array) or isinstance(rt, dt.Array):
                return dt.lub(lt, rt) if isinstance(lt, dt.Array) and isinstance(rt, dt.Array) else (lt if isinstance(lt, dt.Array) else rt)
            if isinstance(lt, (dt.Tuple, dt.List)) and op == "+":
                return dt.ANY_TUPLE
        return dt.ANY
    if isinstance(e, expr_mod.ColumnUnaryOpExpression):
        it = _infer(e._expr, table)
        if e._operator == "~":
            return it
        return it
    if isinstance(e, (expr_mod.IsNoneExpression, expr_mod.IsNotNoneExpression)):
        return dt.BOOL
    if isinstance(e, expr_mod.IfElseExpression):
        return dt.lub(_infer(e._then, table), _infer(e._else, table))
    if isinstance(e, expr_mod.CoalesceExpression):
        parts = [_infer(a, table) for a in e._args]
        # result optional only if all optional
        stripped = [p.strip_optional() for p in parts]
        out = dt.lub(*stripped)
        if all(p.is_optional() or p is dt.NONE for p in parts):
            return dt.Optional(out)
        return out
    if isinstance(e, expr_mod.RequireExpression):
        inner = _infer(e._val, table)
        return dt.Optional(inner)
    if isinstance(e, expr_mod.CastExpression):
        src = _infer(e._expr, table)
        if src.is_optional():
            return dt.Optional(e._target.strip_optional())
        return e._target
    if isinstance(e, expr_mod.ConvertExpression):
        return (
            dt.Optional(e._target)
            if not e._unwrap and _infer(e._expr, table).is_optional()
            else e._target
        )
    if isinstance(e, expr_mod.DeclareTypeExpression):
        return e._target
    if isinstance(e, expr_mod.UnwrapExpression):
        return _infer(e._expr, table).strip_optional()
    if isinstance(e, expr_mod.FillErrorExpression):
        return dt.lub(_infer(e._expr, table), _infer(e._replacement, table))
    if isinstance(e, expr_mod.PointerExpression):
        target = getattr(e._table, "_schema", None)
        base = dt.Pointer(target)
        return dt.Optional(base) if e._optional else base
    if isinstance(e, expr_mod.MakeTupleExpression):
        return dt.Tuple(*[_infer(a, table) for a in e._args])
    if isinstance(e, expr_mod.GetExpression):
        ot = _infer(e._obj, table)
        if ot is dt.JSON:
            return dt.JSON
        if isinstance(ot, dt.List):
            return dt.Optional(ot.wrapped) if e._check_if_exists else ot.wrapped
        if isinstance(ot, dt.Tuple) and isinstance(
            e._index, expr_mod.ColumnConstExpression
        ):
            i = e._index._value
            if isinstance(i, int) and -len(ot.args) <= i < len(ot.args):
                return ot.args[i]
        return dt.ANY
    if isinstance(e, expr_mod.MethodCallExpression):
        if e._return_type is not None:
            return e._return_type
        args0 = _infer(e._args[0], table) if e._args else dt.ANY
        return args0
    if isinstance(e, expr_mod.ReducerExpression):
        name = e._reducer.name
        if name == "count":
            return dt.INT
        arg = _infer(e._args[0], table) if e._args else dt.ANY
        if name in ("sum", "min", "max", "unique", "any", "earliest", "latest"):
            return arg
        if name == "avg":
            return dt.FLOAT
        if name in ("argmin", "argmax"):
            return dt.ANY_POINTER
        if name in ("sorted_tuple", "tuple"):
            return dt.List(arg)
        if name in ("ndarray", "npsum"):
            return dt.ANY_ARRAY
        return dt.ANY
    if isinstance(e, expr_mod.ApplyExpression):
        return e._return_type
    if isinstance(e, expr_mod.IxExpression):
        t = e._ix_table
        try:
            inner = t._schema.__columns__[e._column].dtype
        except Exception:
            inner = dt.ANY
        return dt.Optional(inner) if e._optional else inner
    return dt.ANY
