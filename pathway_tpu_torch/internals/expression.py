"""Column expression tree.

Parity with reference ``python/pathway/internals/expression.py``: lazy
expression nodes built by operator overloading on column references; evaluated
by the engine's vectorized evaluator (numpy for irregular columns, vectorized
for dense numeric subtrees — the opposite of the reference's per-row Rust
interpreter, ``src/engine/expression.rs``).
"""

from __future__ import annotations

import typing
from typing import Any, Callable, Iterable

from pathway_tpu_torch.internals import dtype as dt


class ColumnExpression:
    """Base class of all column expressions."""

    _dtype: dt.DType | None = None

    # --- arithmetic ---
    def __add__(self, other):
        return ColumnBinaryOpExpression(self, other, "+")

    def __radd__(self, other):
        return ColumnBinaryOpExpression(other, self, "+")

    def __sub__(self, other):
        return ColumnBinaryOpExpression(self, other, "-")

    def __rsub__(self, other):
        return ColumnBinaryOpExpression(other, self, "-")

    def __mul__(self, other):
        return ColumnBinaryOpExpression(self, other, "*")

    def __rmul__(self, other):
        return ColumnBinaryOpExpression(other, self, "*")

    def __truediv__(self, other):
        return ColumnBinaryOpExpression(self, other, "/")

    def __rtruediv__(self, other):
        return ColumnBinaryOpExpression(other, self, "/")

    def __floordiv__(self, other):
        return ColumnBinaryOpExpression(self, other, "//")

    def __rfloordiv__(self, other):
        return ColumnBinaryOpExpression(other, self, "//")

    def __mod__(self, other):
        return ColumnBinaryOpExpression(self, other, "%")

    def __rmod__(self, other):
        return ColumnBinaryOpExpression(other, self, "%")

    def __pow__(self, other):
        return ColumnBinaryOpExpression(self, other, "**")

    def __rpow__(self, other):
        return ColumnBinaryOpExpression(other, self, "**")

    def __matmul__(self, other):
        return ColumnBinaryOpExpression(self, other, "@")

    def __rmatmul__(self, other):
        return ColumnBinaryOpExpression(other, self, "@")

    def __lshift__(self, other):
        return ColumnBinaryOpExpression(self, other, "<<")

    def __rshift__(self, other):
        return ColumnBinaryOpExpression(self, other, ">>")

    # --- comparison ---
    def __eq__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression(self, other, "==")

    def __ne__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression(self, other, "!=")

    def __lt__(self, other):
        return ColumnBinaryOpExpression(self, other, "<")

    def __le__(self, other):
        return ColumnBinaryOpExpression(self, other, "<=")

    def __gt__(self, other):
        return ColumnBinaryOpExpression(self, other, ">")

    def __ge__(self, other):
        return ColumnBinaryOpExpression(self, other, ">=")

    # --- boolean ---
    def __and__(self, other):
        return ColumnBinaryOpExpression(self, other, "&")

    def __rand__(self, other):
        return ColumnBinaryOpExpression(other, self, "&")

    def __or__(self, other):
        return ColumnBinaryOpExpression(self, other, "|")

    def __ror__(self, other):
        return ColumnBinaryOpExpression(other, self, "|")

    def __xor__(self, other):
        return ColumnBinaryOpExpression(self, other, "^")

    def __rxor__(self, other):
        return ColumnBinaryOpExpression(other, self, "^")

    def __invert__(self):
        return ColumnUnaryOpExpression(self, "~")

    def __neg__(self):
        return ColumnUnaryOpExpression(self, "-")

    def __abs__(self):
        return ColumnUnaryOpExpression(self, "abs")

    def __bool__(self):
        raise TypeError(
            "ColumnExpression is lazy and has no truth value; "
            "use & | ~ instead of and/or/not, and pw.if_else for branches"
        )

    def __hash__(self):
        return id(self)

    # --- methods ---
    def is_none(self):
        return IsNoneExpression(self)

    def is_not_none(self):
        return IsNotNoneExpression(self)

    def as_int(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(self, dt.INT, unwrap=unwrap, default=default)

    def as_float(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(self, dt.FLOAT, unwrap=unwrap, default=default)

    def as_str(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(self, dt.STR, unwrap=unwrap, default=default)

    def as_bool(self, *, unwrap: bool = False, default=None):
        return ConvertExpression(self, dt.BOOL, unwrap=unwrap, default=default)

    def to_string(self):
        return MethodCallExpression("to_string", self)

    def get(self, index, default=None):
        return GetExpression(self, index, default=default, check_if_exists=True)

    def __getitem__(self, index):
        return GetExpression(self, index, default=None, check_if_exists=False)

    @property
    def dt(self):
        from pathway_tpu_torch.internals.expressions import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from pathway_tpu_torch.internals.expressions import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from pathway_tpu_torch.internals.expressions import NumericalNamespace

        return NumericalNamespace(self)

    # --- structure ---
    def _deps(self) -> tuple["ColumnExpression", ...]:
        return ()

    def _dependencies(self) -> list["ColumnReference"]:
        out: list[ColumnReference] = []
        stack: list[ColumnExpression] = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, ColumnReference):
                out.append(e)
            stack.extend(e._deps())
        return out

    def _tables(self):
        tables = []
        for ref in self._dependencies():
            if ref._table is not None and ref._table not in tables:
                tables.append(ref._table)
        return tables


ColumnExpressionOrValue = Any


def smart_coerce(value: ColumnExpressionOrValue) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    return ColumnConstExpression(value)


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value

    def __repr__(self):
        return repr(self._value)

    def _deps(self):
        return ()


class ColumnReference(ColumnExpression):
    """``table.column`` / ``table['column']`` / ``pw.this.column``."""

    def __init__(self, table, name: str):
        self._table = table
        self._name = name

    @property
    def table(self):
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"<{type(self._table).__name__}>.{self._name}"

    def _deps(self):
        return ()


class ColumnBinaryOpExpression(ColumnExpression):
    def __init__(self, left, right, op: str):
        self._left = smart_coerce(left)
        self._right = smart_coerce(right)
        self._operator = op

    def __repr__(self):
        return f"({self._left!r} {self._operator} {self._right!r})"

    def _deps(self):
        return (self._left, self._right)


class ColumnUnaryOpExpression(ColumnExpression):
    def __init__(self, expr, op: str):
        self._expr = smart_coerce(expr)
        self._operator = op

    def __repr__(self):
        return f"({self._operator}{self._expr!r})"

    def _deps(self):
        return (self._expr,)


class ReducerExpression(ColumnExpression):
    """An aggregation over a grouped context — ``pw.reducers.sum(t.a)``."""

    def __init__(self, reducer, *args, **kwargs):
        self._reducer = reducer
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = kwargs

    def __repr__(self):
        return f"pw.reducers.{self._reducer.name}({', '.join(map(repr, self._args))})"

    def _deps(self):
        return self._args


class ApplyExpression(ColumnExpression):
    def __init__(
        self,
        fun: Callable,
        return_type: Any,
        propagate_none: bool = False,
        deterministic: bool = True,
        args: tuple = (),
        kwargs: dict | None = None,
        max_batch_size: int | None = None,
        batched: bool = False,
        submit: Callable | None = None,
        resolve: Callable | None = None,
        deferred: bool = False,
    ):
        self._fun = fun
        self._return_type = dt.wrap(return_type) if return_type is not None else dt.ANY
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = {k: smart_coerce(v) for k, v in (kwargs or {}).items()}
        self._max_batch_size = max_batch_size
        # batched=True: ``fun`` takes parallel LISTS of argument values for a
        # whole epoch batch and returns a list of results — the microbatch
        # that becomes one padded device call for device-backed UDFs (the analog of
        # the reference draining a timely batch, operators.rs:269-305)
        self._batched = batched
        # two-phase batched UDFs: ``submit`` dispatches one microbatch and
        # returns a handle WITHOUT waiting for the device; ``resolve`` turns
        # a list of handles into a list of result-lists with ONE device
        # drain. On a remote/tunneled accelerator this pipelines the chunks
        # of an epoch instead of paying a round trip per chunk.
        self._submit_fun = submit
        self._resolve_fun = resolve
        # deferred=True (fully-async two-phase): the Rowwise operator
        # dispatches the chunks and returns WITHOUT blocking the epoch —
        # results are drained off-thread and injected at a later engine
        # time, so the scheduler keeps pumping while the device computes
        # (reference fully-async UDF semantics with device pipelining)
        self._deferred = deferred
        self._check_for_disallowed_types = False

    def __repr__(self):
        return f"pw.apply({getattr(self._fun, '__name__', self._fun)}, ...)"

    def _deps(self):
        return self._args + tuple(self._kwargs.values())


class AsyncApplyExpression(ApplyExpression):
    """Async UDF application — microbatched into padded device calls when the
    UDF is device-backed (reference async_apply_table, dataflow.rs:1442)."""


class FullyAsyncApplyExpression(AsyncApplyExpression):
    """Non-blocking async apply: emits ``Pending`` and retracts when done."""

    autocommit_duration_ms: int | None = 1500


class CastExpression(ColumnExpression):
    def __init__(self, expr, target: Any):
        self._expr = smart_coerce(expr)
        self._target = dt.wrap(target)

    def __repr__(self):
        return f"pw.cast({self._target!r}, {self._expr!r})"

    def _deps(self):
        return (self._expr,)


class ConvertExpression(ColumnExpression):
    """Json/Any → typed conversion (``.as_int()`` etc.)."""

    def __init__(self, expr, target: dt.DType, unwrap: bool = False, default=None):
        self._expr = smart_coerce(expr)
        self._target = target
        self._unwrap = unwrap
        self._default = smart_coerce(default)

    def __repr__(self):
        return f"{self._expr!r}.as_{str(self._target).lower()}()"

    def _deps(self):
        return (self._expr, self._default)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, expr, target: Any):
        self._expr = smart_coerce(expr)
        self._target = dt.wrap(target)

    def __repr__(self):
        return f"pw.declare_type({self._target!r}, {self._expr!r})"

    def _deps(self):
        return (self._expr,)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args):
        if not args:
            raise ValueError("pw.coalesce requires at least one argument")
        self._args = tuple(smart_coerce(a) for a in args)

    def __repr__(self):
        return f"pw.coalesce({', '.join(map(repr, self._args))})"

    def _deps(self):
        return self._args


class RequireExpression(ColumnExpression):
    def __init__(self, value, *args):
        self._val = smart_coerce(value)
        self._args = tuple(smart_coerce(a) for a in args)

    def __repr__(self):
        return f"pw.require({self._val!r}, ...)"

    def _deps(self):
        return (self._val,) + self._args


class IfElseExpression(ColumnExpression):
    def __init__(self, if_, then, else_):
        self._if = smart_coerce(if_)
        self._then = smart_coerce(then)
        self._else = smart_coerce(else_)

    def __repr__(self):
        return f"pw.if_else({self._if!r}, {self._then!r}, {self._else!r})"

    def _deps(self):
        return (self._if, self._then, self._else)


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr):
        self._expr = smart_coerce(expr)

    def __repr__(self):
        return f"{self._expr!r}.is_none()"

    def _deps(self):
        return (self._expr,)


class IsNotNoneExpression(ColumnExpression):
    def __init__(self, expr):
        self._expr = smart_coerce(expr)

    def __repr__(self):
        return f"{self._expr!r}.is_not_none()"

    def _deps(self):
        return (self._expr,)


class PointerExpression(ColumnExpression):
    """``table.pointer_from(*args, optional=..., instance=...)``"""

    def __init__(self, table, *args, optional: bool = False, instance=None):
        self._table = table
        self._args = tuple(smart_coerce(a) for a in args)
        self._optional = optional
        self._instance = smart_coerce(instance) if instance is not None else None

    def __repr__(self):
        return f"pointer_from({', '.join(map(repr, self._args))})"

    def _deps(self):
        deps = self._args
        if self._instance is not None:
            deps = deps + (self._instance,)
        return deps


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = tuple(smart_coerce(a) for a in args)

    def __repr__(self):
        return f"pw.make_tuple({', '.join(map(repr, self._args))})"

    def _deps(self):
        return self._args


class GetExpression(ColumnExpression):
    def __init__(self, obj, index, default=None, check_if_exists: bool = True):
        self._obj = smart_coerce(obj)
        self._index = smart_coerce(index)
        self._default = smart_coerce(default)
        self._check_if_exists = check_if_exists

    def __repr__(self):
        return f"{self._obj!r}[{self._index!r}]"

    def _deps(self):
        return (self._obj, self._index, self._default)


class MethodCallExpression(ColumnExpression):
    """Namespaced method call (``expr.dt.year()``, ``expr.str.lower()``)."""

    def __init__(self, method: str, *args, return_type: Any = None, **kwargs):
        self._method = method
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = kwargs
        self._return_type = dt.wrap(return_type) if return_type is not None else None

    def __repr__(self):
        return f"{self._args[0]!r}.{self._method}(...)" if self._args else self._method

    def _deps(self):
        return self._args


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr):
        self._expr = smart_coerce(expr)

    def __repr__(self):
        return f"pw.unwrap({self._expr!r})"

    def _deps(self):
        return (self._expr,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr, replacement):
        self._expr = smart_coerce(expr)
        self._replacement = smart_coerce(replacement)

    def __repr__(self):
        return f"pw.fill_error({self._expr!r}, {self._replacement!r})"

    def _deps(self):
        return (self._expr, self._replacement)


class IxExpression(ColumnExpression):
    """``other_table.ix(expr).column`` — pointer-based lookup into a table."""

    def __init__(self, table, key_expr, column: str, optional: bool = False):
        self._ix_table = table
        self._key_expr = smart_coerce(key_expr)
        self._column = column
        self._optional = optional

    def __repr__(self):
        return f"ix({self._key_expr!r}).{self._column}"

    @property
    def name(self) -> str:
        """Column name this lookup projects — lets ``t.select(other.ix(k).col)``
        work positionally like a plain reference, as in the reference API."""
        return self._column

    def _deps(self):
        return (self._key_expr,)


# ---------------------------------------------------------------------------
# top-level expression constructors (exported as pw.*)


def if_else(if_clause, then_clause, else_clause) -> IfElseExpression:
    return IfElseExpression(if_clause, then_clause, else_clause)


def coalesce(*args) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val, *args) -> RequireExpression:
    return RequireExpression(val, *args)


def cast(target_type, expr) -> CastExpression:
    return CastExpression(expr, target_type)


def declare_type(target_type, expr) -> DeclareTypeExpression:
    return DeclareTypeExpression(expr, target_type)


def unwrap(expr) -> UnwrapExpression:
    return UnwrapExpression(expr)


def fill_error(expr, replacement) -> FillErrorExpression:
    return FillErrorExpression(expr, replacement)


def make_tuple(*args) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def apply(fun: Callable, *args, **kwargs) -> ApplyExpression:
    """Apply a Python function row-wise; return type inferred from annotations."""
    ret = typing.get_type_hints(fun).get("return") if callable(fun) else None
    return ApplyExpression(fun, ret, args=args, kwargs=kwargs)


def apply_with_type(fun: Callable, result_type, *args, **kwargs) -> ApplyExpression:
    return ApplyExpression(fun, result_type, args=args, kwargs=kwargs)


def apply_async(fun: Callable, *args, **kwargs) -> AsyncApplyExpression:
    ret = typing.get_type_hints(fun).get("return") if callable(fun) else None
    return AsyncApplyExpression(fun, ret, args=args, kwargs=kwargs)


def apply_async_with_type(fun, result_type, *args, **kwargs) -> AsyncApplyExpression:
    return AsyncApplyExpression(fun, result_type, args=args, kwargs=kwargs)


def apply_fully_async(fun: Callable, *args, **kwargs) -> FullyAsyncApplyExpression:
    ret = typing.get_type_hints(fun).get("return") if callable(fun) else None
    return FullyAsyncApplyExpression(fun, ret, args=args, kwargs=kwargs)


_CHILD_EXPR_ATTRS = (
    "_left", "_right", "_expr", "_if", "_then", "_else", "_val",
    "_obj", "_index", "_default", "_replacement", "_instance", "_key_expr",
)


def map_child_expressions(e, fn):
    """Shallow-copy ``e`` with ``fn`` applied to every direct child
    ColumnExpression (single attrs, ``_args`` tuple, ``_kwargs`` values).
    The single registry of child attributes for all expression rewriters."""
    import copy

    e = copy.copy(e)
    for attr in _CHILD_EXPR_ATTRS:
        if hasattr(e, attr):
            v = getattr(e, attr)
            if isinstance(v, ColumnExpression):
                setattr(e, attr, fn(v))
    if hasattr(e, "_args"):
        e._args = tuple(
            fn(a) if isinstance(a, ColumnExpression) else a for a in e._args
        )
    if hasattr(e, "_kwargs") and isinstance(e._kwargs, dict):
        e._kwargs = {
            k: (fn(v) if isinstance(v, ColumnExpression) else v)
            for k, v in e._kwargs.items()
        }
    return e
