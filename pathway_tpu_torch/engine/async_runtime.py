"""The bounded stage worker (counterpart of ``StageWorker`` in
``pathway_tpu/engine/async_runtime.py``): a daemon thread draining a
bounded work queue. The serving loop's tier-2 prefix cache stages its
host-to-device promotions on one."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

_STOP = object()


class StageWorker:
    """One pipeline stage: a daemon thread draining a bounded work queue.

    ``submit`` blocks once ``maxsize`` items are in flight; that bound is
    the stage's backpressure. ``fn`` must be total (route failures into the
    work item): a raising ``fn`` would drop its item, so exceptions are
    swallowed here only as a last guard that keeps the stage alive for the
    items after it.
    """

    def __init__(self, fn: Callable[[Any], None], maxsize: int, name: str):
        self._fn = fn
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(maxsize)))
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> None:
        """Enqueue ``item``; blocks while the stage queue is full."""
        if self._closed:
            raise RuntimeError(f"StageWorker {self._thread.name} is closed")
        self._queue.put(item)

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            try:
                self._fn(item)
            except Exception:  # noqa: BLE001 - see class docstring
                pass

    def close(self, join: bool = True) -> None:
        """Drain queued items, stop the thread. Idempotent."""
        if not self._closed:
            self._closed = True
            self._queue.put(_STOP)
        if join and self._thread.is_alive():
            self._thread.join(timeout=30)
