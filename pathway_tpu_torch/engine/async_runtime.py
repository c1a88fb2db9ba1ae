"""The async-UDF event loop and the bounded stage worker (counterpart of
``pathway_tpu/engine/async_runtime.py``).

One long-lived background loop thread serves every async-UDF microbatch,
so blocking resolution works whether or not the calling thread has a
running loop of its own (the reference's current-thread tokio runtime,
``src/async_runtime.rs``).

``StageWorker`` is a daemon thread draining a bounded work queue. The
embedder's ingest pipeline chains two of them (tokenize -> dispatch), and
the serving loop's tier-2 prefix cache stages its host-to-device
promotions on one."""

from __future__ import annotations

import asyncio
import queue
import threading
from typing import Any, Callable, Coroutine

from pathway_tpu_torch.analysis.runtime import make_lock

# lock-discipline declaration (analyzer rule GL401): the shared loop
# singleton may only be touched under its lock. StageWorker needs no
# declaration: its shared state is a thread-safe queue.Queue
_GUARDED_BY = {"_loop": "_loop_lock"}

_loop: asyncio.AbstractEventLoop | None = None
_loop_lock = make_lock("async.loop")


def get_event_loop() -> asyncio.AbstractEventLoop:
    global _loop
    with _loop_lock:
        if _loop is None or _loop.is_closed():
            loop = asyncio.new_event_loop()
            thread = threading.Thread(
                target=loop.run_forever, name="pathway-tpu-torch:async", daemon=True
            )
            thread.start()
            _loop = loop
        return _loop


def run_coroutine_blocking(coro: Coroutine) -> Any:
    """Run a coroutine on the shared background loop; block until done."""
    future = asyncio.run_coroutine_threadsafe(coro, get_event_loop())
    return future.result()


_STOP = object()


class StageWorker:
    """One pipeline stage: a daemon thread draining a bounded work queue.

    ``submit`` blocks once ``maxsize`` items are in flight; that bound is
    the stage's backpressure. ``fn`` must be total (route failures into the
    work item): a raising ``fn`` would drop its item, so every exception,
    ``BaseException`` included, is swallowed here only as a last guard that
    keeps the stage alive for the items after it.
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
            except BaseException:  # noqa: BLE001 - see class docstring
                pass

    def close(self, join: bool = True) -> None:
        """Drain queued items, stop the thread. Idempotent."""
        if not self._closed:
            self._closed = True
            self._queue.put(_STOP)
        if join and self._thread.is_alive():
            self._thread.join(timeout=30)
