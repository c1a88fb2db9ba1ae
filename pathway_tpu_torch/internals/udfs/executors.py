"""UDF executors: sync, async (batch-gathered), fully-async, auto.

Parity with reference ``internals/udfs/executors.py``. The async executor
resolves one epoch's rows concurrently (capacity / timeout / retry options) —
the same batch that becomes a padded device call for device-backed UDFs.
"""

from __future__ import annotations

import asyncio
import functools
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.internals.udfs.retries import AsyncRetryStrategy, NoRetryStrategy


class Executor:
    def _wrap(self, fun: Callable) -> Callable:
        return fun


@dataclass
class SyncExecutor(Executor):
    def _wrap(self, fun):
        return fun


class AsyncExecutor(Executor):
    def __init__(
        self,
        *,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
    ):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy

    def _wrap(self, fun):
        from pathway_tpu_torch.internals.udfs import coerce_async

        fun = coerce_async(fun)
        capacity = self.capacity
        timeout = self.timeout
        retry = self.retry_strategy
        semaphores: dict[int, asyncio.Semaphore] = {}

        @functools.wraps(fun)
        async def wrapper(*args, **kwargs):
            async def attempt():
                if timeout is not None:
                    return await asyncio.wait_for(fun(*args, **kwargs), timeout)
                return await fun(*args, **kwargs)

            async def with_retries():
                if retry is None:
                    return await attempt()
                return await retry.invoke(attempt)

            if capacity is not None:
                loop_id = id(asyncio.get_running_loop())
                sem = semaphores.get(loop_id)
                if sem is None:
                    sem = semaphores[loop_id] = asyncio.Semaphore(capacity)
                async with sem:
                    return await with_retries()
            return await with_retries()

        return wrapper


class FullyAsyncExecutor(AsyncExecutor):
    """Non-blocking apply: results arrive at later engine times.

    On a deterministic two-phase batched UDF (``submit_batch`` /
    ``resolve_batch``, e.g. the embedders) this selects the DEFERRED
    engine path: the epoch dispatches the chunks and returns immediately;
    a drainer thread injects the completed rows at a fresh engine time
    (``RowwiseNode._step_deferred``). For plain async functions it keeps
    the within-epoch concurrent resolution (documented divergence from
    the reference's ``Pending``-placeholder column)."""


@dataclass
class AutoExecutor(Executor):
    pass


def auto_executor() -> AutoExecutor:
    return AutoExecutor()


def sync_executor() -> SyncExecutor:
    return SyncExecutor()


def async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> AsyncExecutor:
    return AsyncExecutor(
        capacity=capacity, timeout=timeout, retry_strategy=retry_strategy
    )


def fully_async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    autocommit_duration_ms: int | None = 1500,
) -> FullyAsyncExecutor:
    return FullyAsyncExecutor(
        capacity=capacity, timeout=timeout, retry_strategy=retry_strategy
    )


def with_capacity(func: Callable, capacity: int) -> Callable:
    """Limit the number of simultaneous calls of ``func`` (reference
    ``udfs/executors.py:227``). Sync callables are coerced to async."""
    return AsyncExecutor(capacity=capacity)._wrap(func)


def with_timeout(func: Callable, timeout: float) -> Callable:
    """Cancel calls of ``func`` that exceed ``timeout`` seconds (reference
    ``udfs/executors.py:253``). Sync callables are coerced to async."""
    return AsyncExecutor(timeout=timeout)._wrap(func)


def with_retry_strategy(
    func: Callable, retry_strategy: AsyncRetryStrategy
) -> Callable:
    """Retry failing calls of ``func`` per ``retry_strategy`` (reference
    ``udfs/executors.py``). Sync callables are coerced to async."""
    return AsyncExecutor(retry_strategy=retry_strategy)._wrap(func)


def async_options(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    cache_strategy: Any = None,
) -> Callable:
    """Decorator adding capacity/timeout/retry to an async callable."""

    def decorator(fun):
        wrapped = AsyncExecutor(
            capacity=capacity, timeout=timeout, retry_strategy=retry_strategy
        )._wrap(fun)
        if cache_strategy is not None:
            from pathway_tpu_torch.internals.udfs.caches import with_cache_strategy

            wrapped = with_cache_strategy(wrapped, cache_strategy)
        return wrapped

    return decorator
