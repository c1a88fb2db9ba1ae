"""UDF result caches (reference ``internals/udfs/caches.py``).

``DiskCache`` uses a simple sqlite-backed store (the reference uses the
``diskcache`` package, absent here); ``InMemoryCache`` is an LRU dict.
A ``DiskCache`` value is stored as ``engine.state.host_state`` bytes: a
tensor in it as CPU numpy with its dtype and device, so a hit is
byte-equal to its miss and comes back on the miss's device.

In ``udf_caching`` persistence mode every UDF without a strategy of its
own gets a ``DiskCache`` under the store's root, as in JAX; in the port a
batched UDF gets one too, row by row, and a two-phase (submit / resolve)
UDF submits only the rows that miss (:func:`with_deferred_batch_cache`),
so that a replayed row does no device work.
"""

from __future__ import annotations

import asyncio
import functools
import os
import sqlite3
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

    def get_many(self, keys: list[str]) -> dict[str, Any]:
        """{key: value} of the keys that hit."""
        out = {}
        for k in keys:
            hit, value = self.get(k)
            if hit:
                out[k] = value
        return out

    def put_many(self, items: list[tuple[str, Any]]) -> None:
        for k, v in items:
            self.put(k, v)


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


class DiskCache(CacheStrategy):
    def __init__(self, name: str | None = None, size_limit: int | None = None,
                 root: str | None = None):
        self.name = name
        self.size_limit = size_limit
        # JAX's PATHWAY_PERSISTENT_STORAGE is this argument here
        self.root = root
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _ensure(self):
        if self._conn is None:
            root = (
                _persistence_cache_root()
                or self.root
                or os.path.join(os.getcwd(), ".pw-cache")
            )
            os.makedirs(root, exist_ok=True)
            path = os.path.join(root, f"udf-cache-{self.name or 'default'}.sqlite")
            self._conn = sqlite3.connect(path, check_same_thread=False)
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS cache (k TEXT PRIMARY KEY, v BLOB)"
            )
            self._conn.commit()
        return self._conn

    def get(self, key):
        got = self.get_many([key])
        if key in got:
            return True, got[key]
        return False, None

    def put(self, key, value):
        self.put_many([(key, value)])

    def get_many(self, keys):
        from pathway_tpu_torch.engine.state import place_state

        uniq = list(dict.fromkeys(keys))
        found: dict[str, bytes] = {}
        with self._lock:
            conn = self._ensure()
            for i in range(0, len(uniq), 500):  # sqlite's bound-parameter cap
                part = uniq[i:i + 500]
                marks = ",".join("?" * len(part))
                found.update(conn.execute(
                    f"SELECT k, v FROM cache WHERE k IN ({marks})", part).fetchall())
            self.hits += len(found)
            self.misses += len(uniq) - len(found)
        return {k: place_state(v) for k, v in found.items()}

    def put_many(self, items):
        from pathway_tpu_torch.engine.state import host_state

        rows = [(k, host_state(v)) for k, v in items]
        with self._lock:
            conn = self._ensure()
            conn.executemany("INSERT OR REPLACE INTO cache (k, v) VALUES (?, ?)", rows)
            conn.commit()


DefaultCache = DiskCache


def _persistence_cache_root() -> str | None:
    """Root UDF caches in the running persistence store so cached results
    survive restarts alongside snapshots (reference
    ``PersistenceMode::UdfCaching``, ``src/connectors/mod.rs:114``)."""
    from pathway_tpu_torch.internals import config as config_mod

    pcfg = config_mod.persistence()
    backend = getattr(pcfg, "backend", None)
    if backend is not None and getattr(backend, "kind", None) == "filesystem":
        return os.path.join(backend.path, "udf-caches")
    return None


def maybe_default_cache(existing: CacheStrategy | None) -> CacheStrategy | None:
    """In udf_caching persistence mode every UDF gets a DiskCache unless it
    configured its own strategy."""
    if existing is not None:
        return existing
    from pathway_tpu_torch.internals import config as config_mod

    pcfg = config_mod.persistence()
    mode = (getattr(pcfg, "persistence_mode", None) or "").lower()
    if mode == "udf_caching":
        return DiskCache()
    return None


def _udf_cache_for(fun: Callable) -> CacheStrategy | None:
    cache = maybe_default_cache(None)
    if cache is not None and isinstance(cache, DiskCache) and cache.name is None:
        # distinct sqlite file per UDF: two UDFs that share a bare
        # __name__ must not share cached results
        cache.name = f"{getattr(fun, '__module__', '?')}.{getattr(fun, '__qualname__', getattr(fun, '__name__', 'udf'))}"
    return cache


def with_deferred_cache(fun: Callable) -> Callable:
    """Wrap ``fun`` so that, if udf_caching persistence mode is active when
    the dataflow actually runs (config is set at ``pw.run`` time, after UDF
    expressions are built), calls go through a per-UDF DiskCache. The target
    is resolved once on first call and rebound, so steady-state overhead is
    one dict lookup per row."""
    state: dict[str, Callable] = {}

    def resolve() -> Callable:
        target = state.get("fn")
        if target is None:
            cache = _udf_cache_for(fun)
            target = with_cache_strategy(fun, cache) if cache is not None else fun
            state["fn"] = target
        return target

    if asyncio.iscoroutinefunction(fun):

        @functools.wraps(fun)
        async def async_wrapper(*args, **kwargs):
            return await resolve()(*args, **kwargs)

        return async_wrapper

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        return resolve()(*args, **kwargs)

    return wrapper


def with_deferred_batch_cache(fun: Callable, submit: Callable | None,
                              resolve: Callable | None):
    """The batched counterpart of :func:`with_deferred_cache` (the port's
    own: JAX's batched UDFs get no cache in ``udf_caching`` mode): returns
    ``(fun, submit, resolve)`` that go through a per-UDF DiskCache row by
    row if udf_caching mode is on when the UDF first runs. A two-phase UDF
    then submits only its misses, deduplicated, and a chunk of hits does
    no device work at all; its results are stored as it resolves."""
    state: dict[str, Any] = {}
    name = getattr(fun, "__name__", "udf")

    def cache() -> CacheStrategy | None:
        if "cache" not in state:
            state["cache"] = _udf_cache_for(fun)
            if state["cache"] is not None:
                state["fn"] = with_batch_cache_strategy(fun, state["cache"])
        return state["cache"]

    @functools.wraps(fun)
    def wrapped(*arg_lists, **kwarg_lists):
        if cache() is None:
            return fun(*arg_lists, **kwarg_lists)
        return state["fn"](*arg_lists, **kwarg_lists)

    if submit is None or resolve is None:
        return wrapped, submit, resolve

    def cached_submit(*arg_lists, **kwarg_lists):
        c = cache()
        if c is None:
            return ("raw", submit(*arg_lists, **kwarg_lists))
        n = len(arg_lists[0]) if arg_lists else len(next(iter(kwarg_lists.values())))
        keys = [c.make_key(name, tuple(col[i] for col in arg_lists),
                           {k: v[i] for k, v in kwarg_lists.items()}) for i in range(n)]
        hits = c.get_many(keys)
        first: dict[str, int] = {}
        for i, k in enumerate(keys):
            if k not in hits and k not in first:
                first[k] = i
        todo = list(first.values())
        handle = None
        if todo:
            handle = submit(*[[col[i] for i in todo] for col in arg_lists],
                            **{k: [v[i] for i in todo] for k, v in kwarg_lists.items()})
        return ("cached", handle, keys, hits, [keys[i] for i in todo])

    def cached_resolve(handles, *args, **kwargs):
        inner = [h[1] for h in handles if h[1] is not None]
        resolved = iter(resolve(inner, *args, **kwargs) if inner else [])
        out = []
        for h in handles:
            if h[0] == "raw":
                out.append(next(resolved))
                continue
            _, handle, keys, hits, miss_keys = h
            values = dict(hits)
            if handle is not None:
                fresh = list(zip(miss_keys, next(resolved)))
                state["cache"].put_many(fresh)
                values.update(fresh)
            out.append([values[k] for k in keys])
        return out

    return wrapped, cached_submit, cached_resolve


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
        keys = [cache.make_key(name, tuple(col[i] for col in arg_lists),
                               {k: v[i] for k, v in kwarg_lists.items()}) for i in range(n)]
        hits = cache.get_many(keys)
        for i, key in enumerate(keys):
            if key in hits:
                out[i] = hits[key]
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
            by_key = {keys[i]: r for i, r in zip(unique, results)}
            cache.put_many(list(by_key.items()))
            for i in miss:
                out[i] = by_key[keys[i]]
        return out

    return wrapper
