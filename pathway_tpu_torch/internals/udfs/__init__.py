"""UDF system — ``@pw.udf``, executors, caching, retries.

Parity with reference ``internals/udfs/``: ``UDF`` base class, sync/async/auto
executors, capacity/timeout/retry wrappers, disk & in-memory caches. The async
executor is the device microbatching point: whole epochs' rows resolve together
(reference async_apply, operators.rs:269-305).
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import typing
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.udfs.caches import (
    CacheStrategy,
    DefaultCache,
    DiskCache,
    InMemoryCache,
    with_batch_cache_strategy,
    with_cache_strategy,
    with_deferred_batch_cache,
    with_deferred_cache,
)
from pathway_tpu_torch.internals.udfs.executors import (
    AsyncExecutor,
    AutoExecutor,
    Executor,
    FullyAsyncExecutor,
    SyncExecutor,
    async_executor,
    async_options,
    auto_executor,
    fully_async_executor,
    sync_executor,
    with_capacity,
    with_retry_strategy,
    with_timeout,
)
from pathway_tpu_torch.internals.udfs.retries import (
    AsyncRetryStrategy,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    NoRetryStrategy,
)

__all__ = [
    "UDF",
    "udf",
    "UDFSync",
    "UDFAsync",
    "auto_executor",
    "async_executor",
    "sync_executor",
    "fully_async_executor",
    "async_options",
    "CacheStrategy",
    "DefaultCache",
    "DiskCache",
    "InMemoryCache",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
    "coerce_async",
    "with_capacity",
    "with_timeout",
    "with_retry_strategy",
]


def coerce_async(fun: Callable) -> Callable:
    """Wrap a sync callable into a coroutine function."""
    if asyncio.iscoroutinefunction(fun):
        return fun

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return fun(*args, **kwargs)

    return wrapper


class UDF:
    """Base class for user-defined functions applied to table rows.

    Subclasses implement ``__wrapped__``; instances are callable on column
    expressions and build Apply/AsyncApply expression nodes.
    """

    def __init__(
        self,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
        batch: bool = False,
    ):
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor if executor is not None else auto_executor()
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        # batch=True: ``__wrapped__`` receives parallel lists covering a whole
        # epoch microbatch and returns a list — one padded device call per batch
        # for device-backed UDFs (embedders/rerankers). Must be sync.
        self.batch = batch

    def __wrapped__(self, *args, **kwargs):
        raise NotImplementedError

    def _get_return_type(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        try:
            hints = typing.get_type_hints(self.__wrapped__)
            return hints.get("return")
        except Exception:
            return None

    def _prepare_fun(self) -> tuple[Callable, bool]:
        fun = self.__wrapped__
        is_async = asyncio.iscoroutinefunction(fun)
        executor = self.executor
        if isinstance(executor, AutoExecutor):
            executor = AsyncExecutor() if is_async else SyncExecutor()
        fun = executor._wrap(fun)
        if self.cache_strategy is not None:
            fun = with_cache_strategy(fun, self.cache_strategy)
        else:
            fun = with_deferred_cache(fun)
        return fun, isinstance(executor, (AsyncExecutor, FullyAsyncExecutor)) or is_async

    def __call__(self, *args, **kwargs) -> expr_mod.ColumnExpression:
        if self.batch:
            return self._call_batched(args, kwargs)
        fun, is_async = self._prepare_fun()
        rt = self._get_return_type()
        if isinstance(self.executor, FullyAsyncExecutor):
            cls = expr_mod.FullyAsyncApplyExpression
        elif is_async:
            cls = expr_mod.AsyncApplyExpression
        else:
            cls = expr_mod.ApplyExpression
        return cls(
            fun,
            rt,
            propagate_none=self.propagate_none,
            deterministic=self.deterministic,
            args=args,
            kwargs=kwargs,
            max_batch_size=self.max_batch_size,
        )

    def _call_batched(self, args, kwargs) -> expr_mod.ColumnExpression:
        fun = self.__wrapped__
        if inspect.iscoroutinefunction(fun):
            raise TypeError("batch=True UDFs must have a sync __wrapped__")
        # two-phase protocol: a UDF exposing submit_batch/resolve_batch gets
        # its epoch chunks DISPATCHED back-to-back and drained with one
        # device sync, instead of one blocking call per chunk. A cache
        # strategy needs per-call results, so it keeps the blocking path.
        submit = getattr(self, "submit_batch", None)
        resolve = getattr(self, "resolve_batch", None)
        if self.cache_strategy is not None:
            fun = with_batch_cache_strategy(fun, self.cache_strategy)
            submit = resolve = None
        else:
            # udf_caching mode, if on when the UDF first runs: a per-UDF
            # DiskCache row by row, the two-phase path submitting misses only
            fun, submit, resolve = with_deferred_batch_cache(fun, submit, resolve)
        rt = self._get_return_type()
        # a batched __wrapped__ is hinted list[X]; the per-row type is X
        if self.return_type is None and typing.get_origin(rt) is list:
            (rt,) = typing.get_args(rt)
        # FullyAsyncExecutor on a two-phase batched UDF = deferred mode:
        # the epoch doesn't block on the device; results are injected at a
        # later engine time (deterministic only — retractions re-derive
        # the value, so a nondeterministic UDF must keep the replay-cache
        # blocking path)
        deferred = (
            isinstance(self.executor, FullyAsyncExecutor)
            and submit is not None
            and resolve is not None
            and self.deterministic
        )
        return expr_mod.ApplyExpression(
            fun,
            rt,
            propagate_none=self.propagate_none,
            deterministic=self.deterministic,
            args=args,
            kwargs=kwargs,
            max_batch_size=self.max_batch_size,
            batched=True,
            submit=submit,
            resolve=resolve,
            deferred=deferred,
        )


class _FunctionUDF(UDF):
    def __init__(self, fun: Callable, **kwargs):
        super().__init__(**kwargs)
        self._fun = fun
        functools.update_wrapper(self, fun)

    @property
    def __wrapped__(self):
        return self._fun

    @__wrapped__.setter
    def __wrapped__(self, v):
        self._fun = v


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
    batch: bool = False,
):
    """Decorator turning a function into a UDF usable in expressions.

    >>> @pw.udf
    ... def add_one(x: int) -> int:
    ...     return x + 1

    With ``batch=True`` the function receives parallel lists covering a whole
    epoch microbatch and returns a list of results — one padded device call
    per batch for device-backed UDFs.
    """

    def wrapper(f):
        return _FunctionUDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
            batch=batch,
        )

    if fun is not None:
        return wrapper(fun)
    return wrapper


# deprecated aliases kept for parity
def udf_async(fun=None, **kwargs):
    if fun is not None:
        return udf(fun, executor=async_executor(), **kwargs)
    return udf(executor=async_executor(), **kwargs)


UDFSync = UDF
UDFAsync = UDF
