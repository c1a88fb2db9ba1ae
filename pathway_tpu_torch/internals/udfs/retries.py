"""Async retry strategies (reference ``internals/udfs/retries.py``)."""

from __future__ import annotations

import asyncio
import random
import time
from typing import Awaitable, Callable


class AsyncRetryStrategy:
    async def invoke(self, action: Callable[[], Awaitable]) -> object:
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, action):
        return await action()

    def invoke_sync(self, action):
        return action()


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    """Retries with exponentially growing delays, optionally capped.

    ``max_delay_ms`` bounds the per-attempt sleep (pre-jitter): without a
    cap, a long retry budget grows the tail delay geometrically —
    ``max_retries=10`` at the defaults would sleep 8.5 minutes on the
    last attempt alone. ``0`` (the historical behavior) leaves the
    backoff unbounded."""

    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1000,
        backoff_factor: float = 2,
        jitter_ms: int = 300,
        max_delay_ms: int = 0,
    ):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000
        self.max_delay = max_delay_ms / 1000

    def _next_delay(self, delay: float) -> float:
        delay *= self.backoff_factor
        if self.max_delay > 0:
            delay = min(delay, self.max_delay)
        return delay

    def _capped(self, delay: float) -> float:
        if self.max_delay > 0:
            return min(delay, self.max_delay)
        return delay

    async def invoke(self, action):
        delay = self._capped(self.initial_delay)
        for attempt in range(self.max_retries + 1):
            try:
                return await action()
            except Exception:
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(delay + random.random() * self.jitter)
                delay = self._next_delay(delay)
        raise RuntimeError("unreachable")

    def invoke_sync(self, action: Callable[[], object],
                    sleep: Callable[[float], None] = time.sleep) -> object:
        """Blocking twin of :meth:`invoke` for thread-based supervisors
        (serving-loop restarts, worker retries) — same attempt count,
        delay schedule, cap and jitter, but sleeping on the calling
        thread. ``sleep`` is injectable so tests assert the schedule
        without waiting it out."""
        delay = self._capped(self.initial_delay)
        for attempt in range(self.max_retries + 1):
            try:
                return action()
            except Exception:
                if attempt == self.max_retries:
                    raise
                sleep(delay + random.random() * self.jitter)
                delay = self._next_delay(delay)
        raise RuntimeError("unreachable")


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        super().__init__(
            max_retries=max_retries,
            initial_delay=delay_ms,
            backoff_factor=1,
            jitter_ms=0,
        )
