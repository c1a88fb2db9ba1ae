"""Exponential-backoff retries for thread-based supervisors (counterpart
of ``ExponentialBackoffRetryStrategy.invoke_sync`` in
``pathway_tpu/internals/udfs/retries.py``; the port has no async UDFs).

The decode server's supervised restarts and the ingest pipeline's
``embed.h2d`` retry use it: the same attempt count, delay schedule, cap
and jitter as the JAX strategy, sleeping on the calling thread.
"""

from __future__ import annotations

import random
import time
from typing import Callable


class ExponentialBackoffRetryStrategy:
    """Retries with exponentially growing delays, optionally capped.

    ``max_delay_ms`` bounds the per-attempt sleep (before jitter); 0
    leaves the backoff unbounded, as in JAX."""

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

    def _capped(self, delay: float) -> float:
        if self.max_delay > 0:
            return min(delay, self.max_delay)
        return delay

    def invoke_sync(self, action: Callable[[], object],
                    sleep: Callable[[float], None] = time.sleep) -> object:
        """Call ``action`` until it returns, at most ``max_retries + 1``
        times, sleeping between attempts; the last failure propagates.
        ``sleep`` is injectable so tests assert the schedule without
        waiting it out."""
        delay = self._capped(self.initial_delay)
        for attempt in range(self.max_retries + 1):
            try:
                return action()
            except Exception:
                if attempt == self.max_retries:
                    raise
                sleep(delay + random.random() * self.jitter)
                delay = self._capped(delay * self.backoff_factor)
        raise RuntimeError("unreachable")
