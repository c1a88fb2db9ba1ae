"""Epoch scheduler — the engine's worker main loop.

The analog of the reference's timely worker pump (``worker.step_or_park``,
``src/engine/dataflow.rs:5595-5648``): delivers input deltas through the DAG
in strict timestamp order. Totally-ordered logical times (reference
``src/engine/timestamp.rs``: even = connector commits, odd = internal
retractions) make the epoch-synchronous pass equivalent to differential
dataflow progress tracking in the single-dimension case.

With ``EngineConfig(processes=N)`` every process runs the same graph, with
an ``ExchangeNode`` spliced before each stateful operator, and a lockstep
loop over the peer mesh (``engine/exchange.py``) agrees each round on the
next global epoch time and on termination. ``pw.iterate`` runs its body to
a fixpoint on a nested scheduler each round, under the same loop when the
run has several processes. The switches come from the run's
``EngineConfig`` (``internals/config.py``), read once at construction.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Callable

from pathway_tpu_torch.engine.batch import Batch, concat_batches, consolidate
from pathway_tpu_torch.engine.graph import EngineGraph, Node, fuse_chains
from pathway_tpu_torch.engine import probes
from pathway_tpu_torch.engine.probes import SchedulerStats, _current_op


class Scheduler:
    def __init__(self, graph: EngineGraph, targets: list[Node] | None = None,
                 config=None, exchange_ctx=None,
                 ctl_tag_alloc: "Callable[[], int] | None" = None,
                 allow_deferred: bool = True):
        from pathway_tpu_torch.internals import config as config_mod

        self.graph = graph
        self.config = config if config is not None else config_mod.active()
        self.exchange_ctx = exchange_ctx
        # deferred (fully-async) UDF emission needs the run's OUTER pump:
        # nested fixpoint sub-schedulers (iterate rounds) run under their
        # own time discipline and must keep UDFs on the blocking path
        self.allow_deferred = allow_deferred
        # control rounds are tagged by ``ctl_tag_alloc`` when provided:
        # nested schedulers (iterate fixpoint sub-runs) draw from the
        # owning node's private monotonic namespace so their barriers can
        # never be confused with the outer loop's or a sibling's
        self.ctl_tag_alloc = ctl_tag_alloc
        # exchanges are spliced BEFORE fusion plans the order: a fused
        # chain then never swallows an ExchangeNode (it is no fusable stage)
        self._spliced = []
        if exchange_ctx is not None:
            from pathway_tpu_torch.engine.exchange import splice_exchanges

            self._spliced = splice_exchanges(
                graph, graph.topo_order(targets), exchange_ctx
            )
        self.order = graph.topo_order(targets)
        # chain fusion: collapse linear runs of stateless per-row operators
        # into single plan nodes (engine/graph.py:fuse_chains) — one step,
        # one consolidate per chain per epoch instead of one per member.
        # Plan-level only: the user graph is global and stays untouched.
        self.fused_chains: list[list[Node]] = []
        if self.config.fusion:
            self.order, self.fused_chains = fuse_chains(self.order, targets)
        self._order_ids = {n.id for n in self.order}
        # close-out cut: the end-of-epoch on_time_end sweep only has work
        # at nodes that OVERRIDE the hook (buffers, subscribes); for
        # everything else the base impl returns [] — broadcasting the
        # frontier to the whole order was pure per-epoch overhead on
        # streaming graphs that pump one small commit per epoch.
        # epoch_closeout=False restores the full sweep.
        self.closeout = self.config.epoch_closeout
        if self.closeout:
            self._sweep_nodes = [
                n for n in self.order
                if type(n).on_time_end is not Node.on_time_end
            ]
        else:
            self._sweep_nodes = list(self.order)
        # threads > 1: step independent operators (same topo level)
        # concurrently — the in-process analog of the reference's worker
        # threads. numpy/jax kernels release the GIL, so dense operators
        # genuinely overlap; results are deterministic because a level only
        # starts after every producer level finished.
        self._n_threads = max(1, self.config.threads)
        self._pool = None
        self._levels: list[list[Node]] | None = None
        if self._n_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self._n_threads,
                thread_name_prefix="pathway:work",
            )
            level_of: dict[int, int] = {}
            levels: dict[int, list[Node]] = {}
            for n in self.order:
                lvl = 1 + max(
                    (level_of.get(i.id, 0) for i in n.inputs), default=0
                )
                level_of[n.id] = lvl
                levels.setdefault(lvl, []).append(n)
            self._levels = [levels[k] for k in sorted(levels)]
        self._lock = threading.Condition()
        # time -> node_id -> [Batch]; injected events (inputs + late emissions)
        self._pending: dict[int, dict[int, list[Batch]]] = defaultdict(
            lambda: defaultdict(list)
        )
        self._node_by_id = {n.id: n for n in self.order}
        for n in self.order:
            n.scheduler = self
        # live sources: node_id -> current lower bound on future event times
        self._source_frontiers: dict[int, int] = {}
        self._async_inflight = 0
        self._stopped = False
        self.current_time: int = -1
        # operator-telemetry switch, read once here (the registry's master
        # switch, probes.set_metrics, is still checked per call)
        self.op_metrics: bool = bool(self.config.op_metrics)
        self._backlog_counter = 0
        self.stats = SchedulerStats()
        self.stats.fused_chains = len(self.fused_chains)
        self.stats.fused_nodes = sum(len(c) for c in self.fused_chains)

    # ------------------------------------------------------------------ inputs
    def register_source(self, node: Node, initial_time: int = 0) -> None:
        with self._lock:
            self._source_frontiers[node.id] = initial_time

    def advance_source(self, node: Node, new_time: int) -> None:
        with self._lock:
            self._source_frontiers[node.id] = new_time
            self._lock.notify_all()

    def close_source(self, node: Node) -> None:
        with self._lock:
            self._source_frontiers.pop(node.id, None)
            self._lock.notify_all()

    def inject(self, node: Node, time: int, batch: Batch) -> None:
        """Thread-safe event injection (connector threads, async UDF results)."""
        if batch is None or len(batch) == 0:
            return
        with self._lock:
            self._pending[time][node.id].append(batch)
            self._lock.notify_all()

    def pending_backlog(self) -> int:
        """How many injected epoch times wait to be pumped. A cheap peek
        for asynchronous producers (the deferred-UDF drainer) deciding
        whether the engine is hungry (0 -> inject now) or behind
        (>0 -> keep coalescing); approximate by design."""
        with self._lock:
            return len(self._pending)

    def async_begin(self) -> None:
        with self._lock:
            self._async_inflight += 1

    def async_done(self) -> None:
        with self._lock:
            self._async_inflight -= 1
            self._lock.notify_all()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._lock.notify_all()

    # ------------------------------------------------------------------ loop
    def _next_ready_time(self) -> "int | None":
        """Smallest time safe to process (below every live source frontier),
        or None. A min over pending keys, not a sort: a fast producer can
        queue hundreds of commit times, and the pump takes them one epoch
        at a time — sorting the whole set per epoch was O(E^2 log E) across
        a backlog drain."""
        if not self._pending:
            return None
        t = min(self._pending.keys())
        frontier = min(self._source_frontiers.values(), default=None)
        if frontier is not None and t >= frontier:
            return None
        return t

    def run(self) -> None:
        """Process events until all sources are closed and queues drain."""
        if self.exchange_ctx is not None:
            return self._run_multiprocess()
        while True:
            with self._lock:
                while True:
                    if self._stopped:
                        return
                    t = self._next_ready_time()
                    if t is not None:
                        break
                    if (
                        not self._source_frontiers
                        and not self._pending
                        and self._async_inflight == 0
                    ):
                        return
                    self._lock.wait(timeout=0.5)
                injected = self._pending.pop(t)
            self._run_epoch(t, injected)

    def shutdown(self) -> None:
        """Release the worker pool (run.py teardown)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def teardown_exchanges(self) -> None:
        """Close the peer mesh and restore the user graph's original wiring
        (the graph is global; exchanges bound to a dead mesh must not leak
        into later runs). The mesh's byte and round counters stay in
        ``stats.exchange``."""
        if self.exchange_ctx is None:
            return
        from pathway_tpu_torch.engine.exchange import unsplice_exchanges

        unsplice_exchanges(self._spliced)
        self._spliced = []
        self.stats.exchange.update(self.exchange_ctx.counters())
        self.exchange_ctx.close()

    def _run_multiprocess(self) -> None:
        """Lockstep multi-process loop: every round, all processes agree on
        the globally smallest ready epoch time and run that epoch together
        (ExchangeNodes inside the epoch barrier per-operator). A process
        with no local events still runs the epoch — it must serve its side
        of every exchange. Replaces timely's distributed progress tracking
        for the totally-ordered single-dimension case. A deferred UDF's
        drain thread counts as in flight (``async_begin`` / ``async_done``)
        until its last batch is injected, so no process leaves while a
        peer's device results are still coming."""
        ctx = self.exchange_ctx
        rnd = 0
        while True:
            with self._lock:
                if self._stopped:
                    return
                local_t = self._next_ready_time()
                frontier = min(self._source_frontiers.values(), default=None)
                live = bool(self._source_frontiers)
                inflight = self._async_inflight > 0
            tag = self.ctl_tag_alloc() if self.ctl_tag_alloc is not None else rnd
            states = ctx.control_allgather(tag, (local_t, frontier, live, inflight))
            rnd += 1
            times = [s[0] for s in states.values() if s[0] is not None]
            frontiers = [s[1] for s in states.values() if s[1] is not None]
            # a time is globally safe only below every process's source
            # frontier — a peer's source may still emit earlier events that
            # will be exchanged into this process's operators
            global_frontier = min(frontiers) if frontiers else None
            t = min(times) if times else None
            if t is None or (global_frontier is not None and t >= global_frontier):
                if any(s[2] or s[3] for s in states.values()) or times:
                    # wait for LOCAL progress (inject/advance notify the
                    # condition) instead of a flat poll — a new local event
                    # starts the next control round at once, so commit
                    # latency is bounded by peers' wait timeout, not by a
                    # fixed sleep on every hop
                    with self._lock:
                        if not self._stopped:
                            self._lock.wait(timeout=0.02)
                    continue
                return
            with self._lock:
                injected = self._pending.pop(t, {})
            self._run_epoch(t, injected)

    def _step_node(self, node: Node, t: int,
                   outputs: dict[int, "Batch | None"],
                   injected: dict[int, list[Batch]]) -> None:
        ins = [
            outputs.get(i.id) if i.id in self._order_ids else None
            for i in node.inputs
        ]
        extra = injected.get(node.id)
        # sparse stepping: every shipped operator no-ops when all input
        # deltas are None and nothing was injected, so skip the dispatch
        # entirely (the end-of-epoch on_time_end sweep still runs for all
        # nodes). With deferred-UDF streams most epochs touch only the
        # embed->index spine, not the whole graph.
        if (
            extra is None
            and not node.always_step
            and all(b is None for b in ins)
        ):
            self.stats.record_skip()
            return
        started = time.perf_counter()
        op_stats = self.stats.operator(node.id, node.name)
        _current_op.stats = op_stats  # device dispatches attribute here
        try:
            out = node.step(t, ins)
        except Exception as exc:
            from pathway_tpu_torch.internals.trace import add_error_trace

            raise add_error_trace(exc, node.trace)
        finally:
            _current_op.stats = None
        if extra:
            out = concat_batches([out] + extra) if out is not None else concat_batches(extra)
        result = consolidate(out, self.closeout) if out is not None else None
        outputs[node.id] = result
        rows_in = sum(len(b) for b in ins if b is not None) + sum(
            len(b) for b in (extra or [])
        )
        if rows_in or result is not None:
            rows_out = len(result) if result is not None else 0
            dt = time.perf_counter() - started
            self.stats.record_step(node.id, node.name, rows_in, rows_out, dt)
            if self.op_metrics:
                probes.record_op_step(node.name, dt, rows_in, rows_out)

    def _record_backlog(self, t: int) -> None:
        """Backlog/frontier gauges, throttled to every 8th epoch (gauges
        need freshness, not every transition — same cadence the serving
        occupancy gauge uses)."""
        with self._lock:
            pending = len(self._pending)
            inflight = self._async_inflight
            frontier = min(self._source_frontiers.values(), default=None)
        probes.record_backlog("pending_epochs", pending)
        probes.record_backlog("async_inflight", inflight)
        if frontier is not None:
            probes.record_frontier_lag(frontier - t - 1)

    def _run_epoch(self, t: int, injected: dict[int, list[Batch]]) -> None:
        self.current_time = t
        self.stats.current_time = t
        self.stats.epochs_total += 1
        if self.op_metrics:
            self._backlog_counter += 1
            if self._backlog_counter % 8 == 1:
                self._record_backlog(t)
        outputs: dict[int, Batch | None] = {}
        if self._pool is not None and self._levels is not None:
            for level in self._levels:
                if len(level) == 1:
                    self._step_node(level[0], t, outputs, injected)
                    continue
                futures = [
                    self._pool.submit(
                        self._step_node, node, t, outputs, injected
                    )
                    for node in level
                ]
                # wait for the WHOLE level even on failure: abandoned
                # siblings would keep stepping (and, with several
                # processes, block in exchanges) while the caller unwinds
                errors = []
                for f in futures:
                    try:
                        f.result()
                    except Exception as exc:  # noqa: BLE001
                        errors.append(exc)
                if errors:
                    raise errors[0]
        else:
            for node in self.order:
                self._step_node(node, t, outputs, injected)
        # epoch complete: notify operators; collect late emissions
        for node in self._sweep_nodes:
            for future_t, batch in node.on_time_end(t):
                assert future_t > t, f"{node} emitted at non-future time {future_t}"
                self.inject(node, future_t, batch)
