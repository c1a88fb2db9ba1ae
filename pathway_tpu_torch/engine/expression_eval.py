"""Vectorized expression evaluator.

Replaces the reference's per-row interpreted VM (``src/engine/expression.rs``)
with whole-column evaluation: numpy kernels for irregular/object columns and —
for dense numeric subtrees — optional vectorized lowering. Error semantics
match the reference: failures produce the ``ERROR`` sentinel for the affected
rows (logged), not an aborted run.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.value import ERROR, Pointer, hash_values
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.errors import get_global_error_log
from pathway_tpu_torch.internals.json import Json


class EvalEnv:
    """Column environment for one batch: name -> np.ndarray plus row keys."""

    def __init__(self, cols: dict[str, np.ndarray], keys: np.ndarray, n: int):
        self.cols = cols
        self.keys = keys
        self.n = n
        # tables referenced via ix need state lookups
        self.ix_states: dict[Any, Any] = {}


def _object_array(values) -> np.ndarray:
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def broadcast_const(value: Any, n: int) -> np.ndarray:
    if isinstance(value, bool):
        return np.full(n, value, dtype=object)
    if isinstance(value, int):
        return np.full(n, value, dtype=object)
    if isinstance(value, float):
        return np.full(n, value, dtype=object)
    arr = np.empty(n, dtype=object)
    arr[:] = [value] * n if not isinstance(value, (np.ndarray, tuple, list)) else None
    if isinstance(value, (np.ndarray, tuple, list)):
        for i in range(n):
            arr[i] = value
    return arr


def _is_err(v) -> bool:
    return v is ERROR


_err_mask_vec = np.frompyfunc(_is_err, 1, 1)


def error_mask(arr: np.ndarray) -> np.ndarray:
    if arr.dtype != object:
        return np.zeros(len(arr), dtype=bool)
    return _err_mask_vec(arr).astype(bool)


def _log_error(msg: str) -> None:
    get_global_error_log().log(msg)


def _rowwise(fn: Callable, *arrays: np.ndarray, propagate_none=False) -> np.ndarray:
    """Apply fn per row with ERROR propagation; exceptions -> ERROR."""
    n = len(arrays[0]) if arrays else 0
    out = np.empty(n, dtype=object)
    for i in range(n):
        args = [a[i] for a in arrays]
        if any(a is ERROR for a in args):
            out[i] = ERROR
            continue
        if propagate_none and any(a is None for a in args):
            out[i] = None
            continue
        try:
            out[i] = fn(*args)
        except Exception as exc:  # noqa: BLE001
            _log_error(f"{type(exc).__name__}: {exc}")
            out[i] = ERROR
    return out


# --------------------------------------------------------------------------
# binary operators

_NUMERIC_OPS: dict[str, Callable] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: _div(a, b),
    "//": lambda a, b: _floordiv(a, b),
    "%": lambda a, b: _mod(a, b),
    "**": lambda a, b: a**b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&": lambda a, b: a & b,
    "|": lambda a, b: a | b,
    "^": lambda a, b: a ^ b,
    "<<": lambda a, b: a << b,
    ">>": lambda a, b: a >> b,
    "@": lambda a, b: a @ b,
}


def _div(a, b):
    if isinstance(a, int) and isinstance(b, int):
        if b == 0:
            raise ZeroDivisionError("division by zero")
        return a / b
    if isinstance(b, (int, float)) and b == 0:
        raise ZeroDivisionError("division by zero")
    return a / b


def _floordiv(a, b):
    if isinstance(b, (int, float)) and b == 0:
        raise ZeroDivisionError("integer division by zero")
    return a // b


def _mod(a, b):
    if isinstance(b, (int, float)) and b == 0:
        raise ZeroDivisionError("modulo by zero")
    return a % b


def eval_binary(op: str, left: np.ndarray, right: np.ndarray) -> np.ndarray:
    fn = _NUMERIC_OPS.get(op)
    if fn is None:
        raise ValueError(f"unknown operator {op}")
    if op in ("==", "!="):
        eq = _rowwise(lambda a, b: _safe_eq(a, b), left, right)
        if op == "!=":
            return _rowwise(lambda v: (not v) if isinstance(v, bool) else v, eq)
        return eq
    return _rowwise(fn, left, right)


def _safe_eq(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


def eval_unary(op: str, arr: np.ndarray) -> np.ndarray:
    if op == "~":
        return _rowwise(lambda v: ~v if not isinstance(v, bool) else (not v), arr)
    if op == "-":
        return _rowwise(lambda v: -v, arr)
    if op == "abs":
        return _rowwise(abs, arr)
    raise ValueError(f"unknown unary operator {op}")


# --------------------------------------------------------------------------
# evaluator


class ExpressionEvaluator:
    """Evaluates a ColumnExpression over an :class:`EvalEnv`."""

    def __init__(self, env: EvalEnv):
        self.env = env

    def eval(self, e: expr_mod.ColumnExpression) -> np.ndarray:
        n = self.env.n
        if isinstance(e, expr_mod.ColumnReference):
            if e._name == "id":
                keys = self.env.keys
                out = np.empty(n, dtype=object)
                for i in range(n):
                    out[i] = Pointer(int(keys[i]))
                return out
            if e._name not in self.env.cols:
                raise KeyError(f"column {e._name!r} not in evaluation environment")
            return self.env.cols[e._name]
        if isinstance(e, expr_mod.ColumnConstExpression):
            return broadcast_const(e._value, n)
        if isinstance(e, expr_mod.ColumnBinaryOpExpression):
            return eval_binary(e._operator, self.eval(e._left), self.eval(e._right))
        if isinstance(e, expr_mod.ColumnUnaryOpExpression):
            return eval_unary(e._operator, self.eval(e._expr))
        if isinstance(e, expr_mod.IsNoneExpression):
            arr = self.eval(e._expr)
            return _rowwise(lambda v: v is None, arr)
        if isinstance(e, expr_mod.IsNotNoneExpression):
            arr = self.eval(e._expr)
            return _rowwise(lambda v: v is not None, arr)
        if isinstance(e, expr_mod.IfElseExpression):
            cond = self.eval(e._if)
            then = self.eval(e._then)
            els = self.eval(e._else)
            return _rowwise(
                lambda c, t, f: (t if c else f) if isinstance(c, bool) else ERROR,
                cond,
                then,
                els,
            )
        if isinstance(e, expr_mod.CoalesceExpression):
            arrays = [self.eval(a) for a in e._args]
            out = np.empty(n, dtype=object)
            for i in range(n):
                val = None
                err = False
                for arr in arrays:
                    v = arr[i]
                    if v is ERROR:
                        err = True
                        break
                    if v is not None:
                        val = v
                        break
                out[i] = ERROR if err else val
            return out
        if isinstance(e, expr_mod.RequireExpression):
            val = self.eval(e._val)
            conds = [self.eval(a) for a in e._args]
            out = np.empty(n, dtype=object)
            for i in range(n):
                if any(c[i] is None for c in conds):
                    out[i] = None
                elif any(c[i] is ERROR for c in conds) or val[i] is ERROR:
                    out[i] = ERROR
                else:
                    out[i] = val[i]
            return out
        if isinstance(e, expr_mod.CastExpression):
            return self._eval_cast(e)
        if isinstance(e, expr_mod.ConvertExpression):
            return self._eval_convert(e)
        if isinstance(e, expr_mod.DeclareTypeExpression):
            return self.eval(e._expr)
        if isinstance(e, expr_mod.UnwrapExpression):
            arr = self.eval(e._expr)

            def _unwrap(v):
                if v is None:
                    raise ValueError("cannot unwrap None")
                return v

            return _rowwise(_unwrap, arr)
        if isinstance(e, expr_mod.FillErrorExpression):
            arr = self.eval(e._expr)
            rep = self.eval(e._replacement)
            out = np.empty(n, dtype=object)
            for i in range(n):
                out[i] = rep[i] if arr[i] is ERROR else arr[i]
            return out
        if isinstance(e, expr_mod.PointerExpression):
            args = [self.eval(a) for a in e._args]
            inst = self.eval(e._instance) if e._instance is not None else None

            def _ptr(*vals):
                if inst is None:
                    return Pointer(hash_values(*vals))
                return None  # handled below

            if inst is None:
                if not args:
                    # pointer_from() with no args addresses the single
                    # global-reduce row (key 0 = hash_values of nothing)
                    out = np.empty(n, dtype=object)
                    out[:] = [Pointer(hash_values()) for _ in range(n)]
                    return out
                return _rowwise(lambda *vals: Pointer(hash_values(*vals)), *args)
            from pathway_tpu_torch.engine.value import ref_scalar_with_instance

            out = np.empty(n, dtype=object)
            for i in range(n):
                vals = [a[i] for a in args]
                if any(v is ERROR for v in vals) or inst[i] is ERROR:
                    out[i] = ERROR
                else:
                    out[i] = ref_scalar_with_instance(*vals, instance=inst[i])
            return out
        if isinstance(e, expr_mod.MakeTupleExpression):
            args = [self.eval(a) for a in e._args]
            out = np.empty(n, dtype=object)
            for i in range(n):
                vals = tuple(a[i] for a in args)
                out[i] = ERROR if any(v is ERROR for v in vals) else vals
            return out
        if isinstance(e, expr_mod.GetExpression):
            return self._eval_get(e)
        if isinstance(e, expr_mod.MethodCallExpression):
            return self._eval_method(e)
        if isinstance(e, expr_mod.ReducerExpression):
            raise ValueError(
                "reducer expression outside of a reduce() context"
            )
        if isinstance(e, expr_mod.ApplyExpression):
            return self._eval_apply(e)
        if isinstance(e, expr_mod.IxExpression):
            return self._eval_ix(e)
        raise TypeError(f"cannot evaluate expression {e!r}")

    # -- specific node evaluators ------------------------------------------
    def _eval_apply(self, e: expr_mod.ApplyExpression) -> np.ndarray:
        args = [self.eval(a) for a in e._args]
        kwargs = {k: self.eval(v) for k, v in e._kwargs.items()}
        n = self.env.n
        if isinstance(e, expr_mod.AsyncApplyExpression):
            return self._eval_apply_async(e, args, kwargs, n)
        if getattr(e, "_batched", False):
            return self._eval_apply_batched(e, args, kwargs, n)
        out = np.empty(n, dtype=object)
        fun = e._fun
        for i in range(n):
            a = [x[i] for x in args]
            kw = {k: v[i] for k, v in kwargs.items()}
            if any(v is ERROR for v in a) or any(v is ERROR for v in kw.values()):
                out[i] = ERROR
                continue
            if e._propagate_none and (
                any(v is None for v in a) or any(v is None for v in kw.values())
            ):
                out[i] = None
                continue
            try:
                out[i] = dt.coerce_value(fun(*a, **kw), e._return_type)
            except Exception as exc:  # noqa: BLE001
                _log_error(f"apply error: {type(exc).__name__}: {exc}")
                out[i] = ERROR
        return out

    def _eval_apply_batched(self, e, args, kwargs, n) -> np.ndarray:
        """Batched UDF: call ``fun`` once per (chunked) epoch batch with
        parallel lists of argument values. This is the device microbatch point —
        one padded device call per chunk instead of one host call per row."""
        out = np.empty(n, dtype=object)
        todo = scan_apply_rows(e, args, kwargs, n, out)
        fun = e._fun
        chunk = e._max_batch_size or len(todo) or 1
        submit = getattr(e, "_submit_fun", None)
        if submit is not None and getattr(e, "_resolve_fun", None) is not None \
                and todo:
            return self._apply_batched_pipelined(
                e, args, kwargs, out, todo, chunk, submit
            )
        for start in range(0, len(todo), chunk):
            idx = todo[start : start + chunk]
            batch_args = [[x[i] for i in idx] for x in args]
            batch_kwargs = {k: [v[i] for i in idx] for k, v in kwargs.items()}
            try:
                results = fun(*batch_args, **batch_kwargs)
                if len(results) != len(idx):
                    raise ValueError(
                        f"batched UDF returned {len(results)} results "
                        f"for a batch of {len(idx)}"
                    )
                for i, r in zip(idx, results):
                    out[i] = dt.coerce_value(r, e._return_type)
            except Exception as exc:  # noqa: BLE001
                _log_error(f"batched apply error: {type(exc).__name__}: {exc}")
                for i in idx:
                    out[i] = ERROR
        return out

    def _apply_batched_pipelined(
        self, e, args, kwargs, out, todo, chunk, submit
    ) -> np.ndarray:
        """Two-phase batched UDF: dispatch every chunk via ``submit`` (no
        device wait), then drain all handles with one ``resolve`` call. On a
        remote accelerator this costs one round trip per EPOCH instead of
        one per chunk (the reference analogously drains a whole timely batch
        into FuturesUnordered, operators.rs:269-305)."""
        handles = submit_apply_chunks(e, args, kwargs, todo, chunk, out)
        return finish_apply_chunks(e, out, handles)

    def _eval_apply_async(self, e, args, kwargs, n) -> np.ndarray:
        """Resolve one epoch's async-UDF calls concurrently (the reference
        drains a timely batch into FuturesUnordered and blocks —
        operators.rs:269-305; this batch is the device microbatch boundary).
        Runs on a dedicated background event loop so it also works when the
        caller's thread already has a running loop (notebooks)."""
        from pathway_tpu_torch.engine.async_runtime import run_coroutine_blocking
        from pathway_tpu_torch.internals.udfs import coerce_async

        fun = coerce_async(e._fun)
        out = np.empty(n, dtype=object)
        todo: list[int] = []
        for i in range(n):
            a = [x[i] for x in args]
            kw = {k: v[i] for k, v in kwargs.items()}
            if any(v is ERROR for v in a) or any(v is ERROR for v in kw.values()):
                out[i] = ERROR
            elif e._propagate_none and (
                any(v is None for v in a) or any(v is None for v in kw.values())
            ):
                out[i] = None
            else:
                todo.append(i)

        async def gather():
            import asyncio

            async def one(i):
                a = [x[i] for x in args]
                kw = {k: v[i] for k, v in kwargs.items()}
                try:
                    return dt.coerce_value(await fun(*a, **kw), e._return_type)
                except Exception as exc:  # noqa: BLE001
                    _log_error(f"async apply error: {type(exc).__name__}: {exc}")
                    return ERROR

            return await asyncio.gather(*[one(i) for i in todo])

        if todo:
            results = run_coroutine_blocking(gather())
            for i, r in zip(todo, results):
                out[i] = r
        return out

    def _eval_cast(self, e: expr_mod.CastExpression) -> np.ndarray:
        arr = self.eval(e._expr)
        target = e._target.strip_optional()

        def _cast(v):
            if v is None:
                return None
            if target is dt.INT:
                return int(v)
            if target is dt.FLOAT:
                return float(v)
            if target is dt.BOOL:
                return bool(v)
            if target is dt.STR:
                return _to_string(v)
            return v

        return _rowwise(_cast, arr)

    def _eval_convert(self, e: expr_mod.ConvertExpression) -> np.ndarray:
        arr = self.eval(e._expr)
        default = self.eval(e._default)
        target = e._target
        unwrap = e._unwrap
        n = self.env.n
        out = np.empty(n, dtype=object)
        for i in range(n):
            v = arr[i]
            if v is ERROR:
                out[i] = ERROR
                continue
            if isinstance(v, Json):
                v = v.value
            if v is None:
                if unwrap:
                    _log_error("cannot unwrap None in as_* conversion")
                    out[i] = ERROR
                else:
                    out[i] = default[i]
                continue
            try:
                if target is dt.INT:
                    if isinstance(v, bool) or not isinstance(v, int):
                        raise ValueError(f"{v!r} is not an int")
                    out[i] = v
                elif target is dt.FLOAT:
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        raise ValueError(f"{v!r} is not a float")
                    out[i] = float(v)
                elif target is dt.STR:
                    if not isinstance(v, str):
                        raise ValueError(f"{v!r} is not a str")
                    out[i] = v
                elif target is dt.BOOL:
                    if not isinstance(v, bool):
                        raise ValueError(f"{v!r} is not a bool")
                    out[i] = v
                else:
                    out[i] = v
            except Exception as exc:  # noqa: BLE001
                _log_error(f"conversion error: {exc}")
                out[i] = ERROR
        return out

    def _eval_get(self, e: expr_mod.GetExpression) -> np.ndarray:
        obj = self.eval(e._obj)
        idx = self.eval(e._index)
        default = self.eval(e._default)
        check = e._check_if_exists
        n = self.env.n
        out = np.empty(n, dtype=object)
        for i in range(n):
            o, ix_, d = obj[i], idx[i], default[i]
            if o is ERROR or ix_ is ERROR:
                out[i] = ERROR
                continue
            try:
                if isinstance(o, Json):
                    res = o[ix_]
                else:
                    res = o[ix_]
                out[i] = res
            except Exception as exc:  # noqa: BLE001
                if check:
                    out[i] = d
                else:
                    _log_error(f"get error: {exc}")
                    out[i] = ERROR
        return out

    def _eval_ix(self, e: expr_mod.IxExpression) -> np.ndarray:
        raise ValueError(
            "ix expressions must be lowered to a join by the table API"
        )

    # -- namespaced methods -------------------------------------------------
    def _eval_method(self, e: expr_mod.MethodCallExpression) -> np.ndarray:
        from pathway_tpu_torch.engine import method_impl

        args = [self.eval(a) for a in e._args]
        return method_impl.dispatch(e._method, args, e._kwargs, self.env.n)


def eval_exprs(
    cols: dict[str, np.ndarray],
    keys: np.ndarray,
    n: int,
    exprs: dict[str, Any],
) -> dict[str, np.ndarray]:
    """Evaluate a named expression program over raw batch arrays.

    The shared evaluation core of ``RowwiseNode.step`` and the fused-chain
    rowwise stage (``operators/core.py:fusable_stage``): one ``EvalEnv`` /
    ``ExpressionEvaluator`` pair per batch, every output column evaluated
    against the SAME input environment (self-referential programs see input
    columns, not freshly computed ones — reference select semantics)."""
    env = EvalEnv(cols, keys, n)
    ev = ExpressionEvaluator(env)
    return {name: ev.eval(e) for name, e in exprs.items()}


def _to_string(v) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, float):
        return repr(v)
    if v is None:
        return "None"
    return str(v)


# -- two-phase batched apply helpers (shared by the in-epoch pipelined path
# and RowwiseNode's deferred drainer) ------------------------------------


def scan_apply_rows(e, args, kwargs, n: int, out: np.ndarray) -> list[int]:
    """Pre-scan one epoch batch for a batched apply: short-circuit ERROR /
    propagated-None rows into ``out`` and return the indexes still to run."""
    todo: list[int] = []
    propagate_none = e._propagate_none
    for i in range(n):
        a = [x[i] for x in args]
        kw = {k: v[i] for k, v in kwargs.items()}
        if any(v is ERROR for v in a) or any(v is ERROR for v in kw.values()):
            out[i] = ERROR
        elif propagate_none and (
            any(v is None for v in a) or any(v is None for v in kw.values())
        ):
            out[i] = None
        else:
            todo.append(i)
    return todo


def submit_apply_chunks(
    e, args, kwargs, todo: list[int], chunk: int, out: np.ndarray
) -> list[tuple[list[int], Any]]:
    """Dispatch every chunk of a two-phase batched apply (no device wait);
    a chunk whose submit raises degrades its rows to ERROR."""
    submit = e._submit_fun
    handles: list[tuple[list[int], Any]] = []
    for start in range(0, len(todo), chunk):
        idx = todo[start : start + chunk]
        batch_args = [[x[i] for i in idx] for x in args]
        batch_kwargs = {k: [v[i] for i in idx] for k, v in kwargs.items()}
        try:
            handles.append((idx, submit(*batch_args, **batch_kwargs)))
        except Exception as exc:  # noqa: BLE001
            _log_error(
                f"batched apply submit error: {type(exc).__name__}: {exc}"
            )
            for i in idx:
                out[i] = ERROR
    return handles


def finish_apply_chunks(
    e, out: np.ndarray, handles: list[tuple[list[int], Any]]
) -> np.ndarray:
    """Drain every submitted chunk with ONE ``resolve`` call and coerce the
    results into ``out`` (the blocking half of the two-phase protocol —
    also run off-thread, chunk at a time, by the deferred Rowwise path)."""
    if not handles:
        return out
    try:
        all_results = e._resolve_fun([h for _, h in handles])
        if len(all_results) != len(handles):
            raise ValueError(
                f"two-phase UDF resolved {len(all_results)} chunks "
                f"for {len(handles)} submitted"
            )
    except Exception as exc:  # noqa: BLE001
        _log_error(f"batched apply resolve error: {type(exc).__name__}: {exc}")
        for idx, _ in handles:
            for i in idx:
                out[i] = ERROR
        return out
    for (idx, _), results in zip(handles, all_results):
        try:
            if len(results) != len(idx):
                raise ValueError(
                    f"batched UDF returned {len(results)} results for "
                    f"a chunk of {len(idx)}"
                )
            for i, r in zip(idx, results):
                out[i] = dt.coerce_value(r, e._return_type)
        except Exception as exc:  # noqa: BLE001 - degrade the chunk only
            _log_error(
                f"batched apply result error: {type(exc).__name__}: {exc}"
            )
            for i in idx:
                out[i] = ERROR
    return out
