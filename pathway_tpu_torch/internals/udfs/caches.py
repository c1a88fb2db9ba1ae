"""UDF result caches (reference ``internals/udfs/caches.py``).

``InMemoryCache`` is an LRU dict. The JAX package's persistent
``DiskCache`` (and the persistence mode that gives every UDF one) waits
for persistence in the port (ROADMAP A13).
"""

from __future__ import annotations

import asyncio
import functools
import threading
from collections import OrderedDict
from typing import Any, Callable

from pathway_tpu_torch.engine.value import hash_values


class CacheStrategy:
    def make_key(self, fun_name: str, args, kwargs) -> str:
        return f"{fun_name}-{hash_values(args, tuple(sorted(kwargs.items())))}"

    def get(self, key: str):  # returns (hit, value)
        raise NotImplementedError

    def put(self, key: str, value) -> None:
        raise NotImplementedError


class InMemoryCache(CacheStrategy):
    def __init__(self, max_size: int | None = None):
        self.max_size = max_size
        self._data: OrderedDict[str, Any] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return True, self._data[key]
            return False, None

    def put(self, key, value):
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            if self.max_size is not None and len(self._data) > self.max_size:
                self._data.popitem(last=False)


def with_cache_strategy(fun: Callable, cache: CacheStrategy) -> Callable:
    name = getattr(fun, "__name__", "udf")
    if asyncio.iscoroutinefunction(fun):

        @functools.wraps(fun)
        async def async_wrapper(*args, **kwargs):
            key = cache.make_key(name, args, kwargs)
            hit, value = cache.get(key)
            if hit:
                return value
            value = await fun(*args, **kwargs)
            cache.put(key, value)
            return value

        return async_wrapper

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        key = cache.make_key(name, args, kwargs)
        hit, value = cache.get(key)
        if hit:
            return value
        value = fun(*args, **kwargs)
        cache.put(key, value)
        return value

    return wrapper


def with_batch_cache_strategy(fun: Callable, cache: CacheStrategy) -> Callable:
    """Row-level cache around a batched UDF: each row of the batch is keyed
    independently; only cache misses are recomputed, in one sub-batch call."""
    name = getattr(fun, "__name__", "udf")

    @functools.wraps(fun)
    def wrapper(*arg_lists, **kwarg_lists):
        n = len(arg_lists[0]) if arg_lists else len(next(iter(kwarg_lists.values())))
        out: list[Any] = [None] * n
        miss: list[int] = []
        keys: list[str] = []
        for i in range(n):
            row_args = tuple(col[i] for col in arg_lists)
            row_kwargs = {k: v[i] for k, v in kwarg_lists.items()}
            key = cache.make_key(name, row_args, row_kwargs)
            keys.append(key)
            hit, value = cache.get(key)
            if hit:
                out[i] = value
            else:
                miss.append(i)
        if miss:
            # dedupe identical rows within the batch: compute each key once
            first_of: dict[str, int] = {}
            unique: list[int] = []
            for i in miss:
                if keys[i] not in first_of:
                    first_of[keys[i]] = i
                    unique.append(i)
            sub_args = [[col[i] for i in unique] for col in arg_lists]
            sub_kwargs = {k: [v[i] for i in unique] for k, v in kwarg_lists.items()}
            results = fun(*sub_args, **sub_kwargs)
            by_key = {}
            for i, r in zip(unique, results):
                cache.put(keys[i], r)
                by_key[keys[i]] = r
            for i in miss:
                out[i] = by_key[keys[i]]
        return out

    return wrapper
