"""Micro-batched query serving over a :class:`FusedRAGPipeline`
(counterpart of ``pathway_tpu/ops/query_server.py``).

Per-query dispatch wastes the card when queries arrive together: the
pipeline's retrieve and retrieve-rerank already take a batch of queries,
so N requests landing in one short window can share ONE stream of
launches instead of N. :class:`QueryServer` follows the continuous decode
server (lock, deque, daemon loop with a failure sweep) and the ingest
stage workers (bounded admission, blocking backpressure):

* ``submit`` enqueues a retrieve or retrieve-rerank request and returns a
  handle; past ``queue_bound`` waiting requests it blocks;
* the loop coalesces what arrived within one ``tick_ms`` window (or
  ``max_batch`` requests, whichever comes first) and makes one batched
  pipeline call per ``(kind, k)`` group: homogeneous load is one call a
  tick;
* results resolve per request; :meth:`QueryServer.stats` reports ticks,
  the batch-size histogram and dispatches.

With ``serve_restarts > 0`` a failing group fails only its own requests
(the sibling groups of its tick and everything queued keep serving), and
a crashed tick fails its batch and the loop goes on, up to
``serve_restarts`` times; with the default 0 the first error latches the
server, as in JAX. Each group dispatch is the ``query.tick`` chaos site
(``engine/chaos.py``). The defaults are the JAX flag defaults;
``tuned_config`` (a tuner artifact's path) sets ``tick_ms`` and
``max_batch`` where the caller leaves them at ``None``. The server is
opt-in: a pipeline called directly is unchanged.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import torch

from pathway_tpu_torch.analysis.annotations import guarded_by
from pathway_tpu_torch.analysis.runtime import make_lock
from pathway_tpu_torch.engine import chaos, probes, tracing
from pathway_tpu_torch.internals.config import apply_tuned_config
from pathway_tpu_torch.internals.errors import get_global_error_log


class QueryRequest:
    """One in-flight query. ``done`` fires once ``result`` or ``error`` is
    set; timestamps are ``time.monotonic()``."""

    __slots__ = ("kind", "text", "k", "done", "result", "error",
                 "submitted_at", "finished_at", "span")

    def __init__(self, kind: str, text: str, k: int):
        self.kind = kind                # "retrieve" | "rerank"
        self.text = text
        self.k = k
        self.done = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.submitted_at = time.monotonic()
        self.finished_at = 0.0
        self.span = tracing.NULL_SPAN  # replaced by QueryServer.submit

    def wait(self, timeout: float | None = None):
        if not self.done.wait(timeout):
            raise TimeoutError("query did not complete in time")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def latency_s(self) -> float:
        return max(0.0, self.finished_at - self.submitted_at)

    def _fail(self, exc: BaseException, now: float) -> None:
        self.error = exc
        self.finished_at = now
        self.span.finish(error=True)
        self.done.set()


@guarded_by(
    _queue="_cond", _stop="_cond", failed="_cond",
    _ticks="_stats_lock", _dispatches="_stats_lock",
    _requests="_stats_lock", _batch_hist="_stats_lock",
    _restarts="_stats_lock", _group_failures="_stats_lock",
    _leaked_thread="_stats_lock",
)
class QueryServer:
    """Coalesces concurrent retrieve / retrieve-rerank requests into
    batched pipeline calls, one per ``(kind, k)`` group per tick."""

    def __init__(self, pipeline, *, tick_ms: float | None = None,
                 max_batch: int | None = None, queue_bound: int = 256,
                 serve_restarts: int = 0, tuned_config: str | None = None):
        self._pipe = pipeline
        # a tuned config's values where the caller passed none, else JAX's
        # defaults (2 ms, 64)
        knobs = apply_tuned_config(tuned_config, "QueryServer",
                                   dict(tick_ms=tick_ms, max_batch=max_batch))
        tick_ms = 2.0 if knobs["tick_ms"] is None else knobs["tick_ms"]
        max_batch = 64 if knobs["max_batch"] is None else knobs["max_batch"]
        self.tick_s = float(tick_ms) / 1e3
        self.max_batch = max(1, int(max_batch))
        self.queue_bound = max(1, int(queue_bound))
        self._cond = threading.Condition(make_lock("query_server.cond"))
        self._queue: deque[QueryRequest] = deque()
        self._stop = False
        self.failed: BaseException | None = None
        self._stats_lock = make_lock("query_server.stats")
        self._ticks = 0
        self._dispatches = 0
        self._requests = 0
        self._batch_hist: dict[int, int] = {}
        self._restarts = 0
        self._group_failures = 0
        self._leaked_thread = 0
        # supervision, read once: budget 0 latches on the first error
        self._restart_budget = max(0, int(serve_restarts))
        self._supervised = self._restart_budget > 0
        self._restarts_left = self._restart_budget
        self._chaos_tick = chaos.site("query.tick")
        # tags this server's request spans in the trace ring
        self._trace_tag = f"query:{id(self):x}"
        self._thread = threading.Thread(target=self._run, name="query-server",
                                        daemon=True)
        self._thread.start()

    def recent_traces(self, n: int | None = None) -> list[dict]:
        """Completed request spans of THIS server (oldest first); empty
        with metrics off."""
        return tracing.recent_traces(server=self._trace_tag, n=n)

    # ------------------------------------------------------------ submit
    def submit(self, text: str, k: int, *, rerank: bool = False) -> QueryRequest:
        """Enqueue a query; blocks (backpressure) while ``queue_bound``
        requests already wait. Returns a handle to ``wait()`` on."""
        kind = "rerank" if rerank else "retrieve"
        if rerank and self._pipe.reranker is None:
            raise ValueError("pipeline has no reranker")
        req = QueryRequest(kind, text, k)
        req.span = tracing.start_span("query", server=self._trace_tag,
                                      query_kind=kind, k=k)
        with self._cond:
            while (len(self._queue) >= self.queue_bound
                   and not self._stop and self.failed is None):
                self._cond.wait(timeout=0.1)
            if self.failed is not None:
                raise RuntimeError("query server failed") from self.failed
            if self._stop:
                raise RuntimeError("query server is shut down")
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def query(self, text: str, k: int, *, rerank: bool = False,
              timeout: float | None = 60.0):
        """Submit and wait."""
        return self.submit(text, k, rerank=rerank).wait(timeout)

    # -------------------------------------------------------------- loop
    def _drain_tick(self) -> list[QueryRequest]:
        """Block until work exists, then hold the tick window open so
        concurrent arrivals coalesce; returns up to ``max_batch``."""
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait()
            if self._stop and not self._queue:
                return []
            deadline = self._queue[0].submitted_at + self.tick_s
            while len(self._queue) < self.max_batch and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            batch = [self._queue.popleft()
                     for _ in range(min(len(self._queue), self.max_batch))]
            self._cond.notify_all()  # unblock backpressured submitters
            return batch

    def _run(self) -> None:
        dev = getattr(self._pipe, "device", None)
        if dev is not None and torch.device(dev).type == "cuda":
            # the pipeline's tensors live on this card: make it current
            with torch.cuda.device(dev):
                self._loop()
        else:
            self._loop()

    def _loop(self) -> None:
        while True:
            batch = self._drain_tick()
            if not batch:
                with self._cond:
                    if self._stop:
                        return
                continue
            try:
                self._serve(batch)
            except BaseException as exc:  # noqa: BLE001 - swept to callers
                now = time.monotonic()
                for req in batch:
                    req._fail(exc, now)
                if self._supervised and self._restarts_left > 0:
                    # the crashed tick's batch failed above; queued and
                    # later requests keep being served until the budget
                    # runs out, then the failure latches
                    self._restarts_left -= 1
                    get_global_error_log().log(
                        f"query server tick crashed ({type(exc).__name__}: "
                        f"{exc}); supervised restart")
                    probes.REGISTRY.counter_add("serve_restarts", server=self._trace_tag)
                    with self._stats_lock:
                        self._restarts += 1
                    continue
                with self._cond:
                    self.failed = exc
                    self._stop = True
                    pending = list(self._queue)
                    self._queue.clear()
                    self._cond.notify_all()
                for req in pending:
                    req._fail(exc, now)
                return

    def _serve(self, batch: list[QueryRequest]) -> None:
        # one batched call per (kind, k) group: a request's result is the
        # per-call path's for the same k
        groups: dict[tuple[str, int], list[QueryRequest]] = {}
        for req in batch:
            req.span.event("admit", batch=len(batch))
            groups.setdefault((req.kind, req.k), []).append(req)
        failed_groups = 0
        for (kind, k), reqs in groups.items():
            try:
                if self._chaos_tick is not None:
                    self._chaos_tick.maybe_fail()
                texts = [r.text for r in reqs]
                if kind == "rerank":
                    results = self._pipe.retrieve_rerank_batch(texts, k)
                else:
                    results = self._pipe.retrieve(texts, k)
            except BaseException as exc:  # noqa: BLE001 - group isolation
                if not self._supervised:
                    raise
                # only THIS group's requests fail; sibling groups and
                # everything queued keep serving
                now = time.monotonic()
                for req in reqs:
                    req._fail(exc, now)
                probes.REGISTRY.counter_add("requests_isolated", float(len(reqs)),
                                            outcome="failed")
                failed_groups += 1
                continue
            now = time.monotonic()
            for req, res in zip(reqs, results):
                req.result = res
                req.finished_at = now
                req.span.event("drain", group=len(reqs))
                req.span.finish()
                req.done.set()
        with self._stats_lock:
            self._ticks += 1
            self._dispatches += len(groups)
            self._requests += len(batch)
            self._group_failures += failed_groups
            n = len(batch)
            self._batch_hist[n] = self._batch_hist.get(n, 0) + 1

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._cond:
            failed = self.failed is not None
        with self._stats_lock:
            ticks, reqs = self._ticks, self._requests
            return {
                "ticks": ticks,
                "requests": reqs,
                "dispatches": self._dispatches,
                "batch_hist": dict(sorted(self._batch_hist.items())),
                "mean_batch": round(reqs / ticks, 3) if ticks else 0.0,
                "failed": failed,
                "restarts": self._restarts,
                "group_failures": self._group_failures,
                "leaked_thread": self._leaked_thread,
            }

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            with self._stats_lock:
                self._leaked_thread += 1
            get_global_error_log().log(
                f"query server thread still alive {timeout}s after shutdown join")
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            if not req.done.is_set():
                req._fail(RuntimeError("query server shut down"), time.monotonic())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
