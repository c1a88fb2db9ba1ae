"""``pw.run`` and the graph runner.

Parity with reference ``internals/run.py`` + ``graph_runner/__init__.py``:
tree-shakes the engine graph from requested outputs, resets run-scoped state,
feeds static sources, starts connector threads and pumps the scheduler until
the frontier closes (or forever for unbounded streaming inputs).

The engine's switches are one ``EngineConfig`` (``internals/config.py``)
that ``run(config=...)`` takes. With ``processes > 1`` the run is one
process of a group that connects a peer mesh (``engine/exchange.py``):
static sources feed on process 0 only, connectors that do not partition
their own input run there only, and every process takes part in each
end-of-stream flush round. ``monitoring_level`` starts the live
dashboard (``internals/monitoring.py``) for the levels that do not resolve
to ``MonitoringLevel.NONE``, and ``with_http_server=True`` the
per-process ``MetricsServer`` (``internals/http_server.py``) for the run,
as in JAX. ``persistence_config`` (a ``pw.persistence.Config``) makes the
run persistent as JAX's does (``persistence/engine_store.py``): each
process keeps its own snapshot log and metadata under its process id,
operator-persisting mode restores every stateful operator or none, and the
run's end snapshots operators and finalizes the store with the readers'
offsets. ``LAST_PERSISTENCE_STATS`` holds the last persistent run's
figures (store bytes written, rows replayed, replay seconds, operators
restored). With a collector endpoint set
(``pw.set_monitoring_config(server_endpoint=...)``) and the OpenTelemetry
SDK importable, the scheduler's run is one ``pathway-tpu.run`` span with
JAX's ``operators`` and ``xpacks`` attributes (``internals/telemetry.py``).
"""

from __future__ import annotations

import contextlib
from typing import Any

from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.operators.output import CaptureNode
from pathway_tpu_torch.engine.scheduler import Scheduler
from pathway_tpu_torch.internals import config as config_mod
from pathway_tpu_torch.internals.parse_graph import G


# stats of the most recent completed run (inspection / tests / dashboards)
LAST_RUN_STATS = None
# the metrics server of the run in progress (pw.run(with_http_server=True))
METRICS_SERVER = None
# the persistence figures of the last persistent run (PersistenceManager.stats)
LAST_PERSISTENCE_STATS = None
# the persistence Config of runs that are given none (the CLI's ``replay``)
_DEFAULT_PERSISTENCE = None
# the EngineConfig of runs that are given none (a ``spawn`` child's)
_DEFAULT_CONFIG = None


class GraphRunner:
    def __init__(self, targets: list[Node], *, config=None, monitoring_level=None,
                 with_http_server: bool = False, persistence_config=None):
        self.targets = targets
        self.config = config if config is not None else _DEFAULT_CONFIG or config_mod.active()
        self.monitoring_level = monitoring_level
        self.with_http_server = with_http_server
        self.persistence_config = persistence_config

    @staticmethod
    def _op_signature(idx: int, node: Node) -> str:
        return f"{idx}:{node.name}:{','.join(node.column_names)}"

    def run(self) -> None:
        prev = config_mod.install(self.config)
        prev_p = config_mod.install_persistence(self.persistence_config)
        try:
            self._run()
        finally:
            config_mod.install(prev)
            config_mod.install_persistence(prev_p)

    def _persistence_manager(self, sched):
        """The run's PersistenceManager (None without a persistence config
        or backend); in operator-persisting mode, every stateful operator's
        snapshot restored, or none."""
        pcfg = self.persistence_config
        if pcfg is None or getattr(pcfg, "backend", None) is None:
            return None
        from pathway_tpu_torch.persistence.engine_store import PersistenceManager

        manager = PersistenceManager(pcfg, worker_id=self.config.process_id,
                                     total_workers=self.config.processes)
        if manager.replay_inputs:
            return manager
        # operator-persisting mode: restore stateful operator snapshots
        # instead of replaying input logs. All-or-nothing: restoring some
        # operators while others start empty would silently drop
        # pre-restart data, so any stateful node without a stored snapshot
        # degrades the whole run to input-snapshot replay (safe, possibly
        # slower).
        staged: list[tuple[Node, bytes]] = []
        missing: list[Node] = []
        for idx, node in enumerate(sched.order):
            if not node.is_stateful():
                continue
            state = manager.load_operator_state(self._op_signature(idx, node))
            if state is None:
                missing.append(node)
            else:
                staged.append((node, state))
        if missing:
            if manager.metadata.current.finalized_time is not None:
                import logging

                logging.getLogger("pathway_tpu_torch").warning(
                    "operator_persisting: no stored state for %s; "
                    "falling back to input-snapshot replay",
                    ", ".join(map(str, missing[:5])),
                )
            manager.force_input_replay()
        else:
            for node, state in staged:
                node.state_restore(state)
            manager.stats["restored_operators"] = len(staged)
        return manager

    @staticmethod
    def _attach_persistence(manager, connectors) -> None:
        seen_ids: dict[str, int] = {}
        for c in connectors:
            if c.persistent_id is None:
                # auto-generate ids from stable per-connector identity
                # (node name + columns), not list position — adding or
                # filtering other connectors must not shift a source's
                # id between record and replay
                sig = f"{c.node.name}:{','.join(c.node.column_names)}"
                n = seen_ids.get(sig, 0)
                seen_ids[sig] = n + 1
                suffix = f"#{n}" if n else ""
                c.persistent_id = f"_pw_auto_{sig}{suffix}"
            c.setup_persistence(manager)

    def _finish_persistence(self, manager, sched, connectors) -> None:
        global LAST_PERSISTENCE_STATS
        errors = [c._persist_error for c in connectors if c._persist_error is not None]
        if errors:
            # a store write that failed (no injected fault) fails the run
            raise errors[0]
        final_time = max(sched.current_time, 0)
        if manager.mode == "operator_persisting":
            # save even when this run degraded to input replay, so the
            # next run can restore
            for idx, node in enumerate(sched.order):
                if not node.is_stateful():
                    continue
                state = node.state_snapshot()
                if state is not None:
                    manager.save_operator_state(self._op_signature(idx, node), state)
        manager.finalize(
            final_time,
            offsets={
                c.persistent_id: c.current_offset()
                for c in connectors
                if c.persistent_id is not None
            },
        )
        LAST_PERSISTENCE_STATS = dict(manager.stats)

    def _run(self) -> None:
        exchange_ctx = None
        pid = self.config.process_id
        if self.config.processes > 1:
            from pathway_tpu_torch.engine.exchange import ExchangeContext, PeerMesh

            exchange_ctx = ExchangeContext(
                PeerMesh(pid, self.config.processes, self.config.first_port))
        try:
            sched = Scheduler(G.engine_graph, self.targets, config=self.config,
                              exchange_ctx=exchange_ctx)
        except BaseException:
            if exchange_ctx is not None:
                exchange_ctx.close()
            raise
        global LAST_RUN_STATS, METRICS_SERVER
        LAST_RUN_STATS = sched.stats
        monitor = metrics_server = None
        try:
            from pathway_tpu_torch.internals.http_server import MetricsServer
            from pathway_tpu_torch.internals.monitoring import maybe_start_monitor

            monitor = maybe_start_monitor(sched.stats, self.monitoring_level)
            if self.with_http_server:
                port = self.config.metrics_first_port
                metrics_server = MetricsServer(
                    sched.stats, port=port + pid if port else 0).start()
                METRICS_SERVER = metrics_server
            involved = {n.id for n in sched.order}
            for node in sched.order:
                node.reset()
                start = getattr(node, "start", None)
                if start is not None:
                    start(self.config)
            manager = self._persistence_manager(sched)
            # static sources (several processes: injected on process 0 only;
            # the exchange layer routes rows to their owner shards)
            static = [
                (node, provider)
                for node, provider in G.static_sources.values()
                if node.id in involved and (exchange_ctx is None or pid == 0)
            ]
            for node, _ in static:
                sched.register_source(node, 0)
            connectors = [c for c in G.connectors if c.node.id in involved]
            if exchange_ctx is not None and pid != 0:
                # connectors that do not partition their input run on process 0
                connectors = [c for c in connectors if c.shardable]
            if manager is not None:
                self._attach_persistence(manager, connectors)
            for c in connectors:
                sched.register_source(c.node, 0)
            for node, provider in static:
                batch = provider()
                if batch is not None and len(batch) > 0:
                    sched.inject(node, 0, batch)
                sched.close_source(node)
        except BaseException:
            # a failure before the run starts must not leave the peers
            # waiting on this process's mesh until their timeout
            sched.teardown_exchanges()
            sched.shutdown()
            self._stop_observers(monitor, metrics_server)
            raise
        from pathway_tpu_torch.internals.telemetry import Telemetry, get_imported_xpacks

        telemetry = Telemetry.create()
        for c in connectors:
            c.start(sched)
        try:
            with telemetry.span(
                "pathway-tpu.run",
                {
                    "operators": len(sched.order),
                    "xpacks": ",".join(get_imported_xpacks()),
                },
            ):
                sched.run()
            # end-of-stream: flush buffers repeatedly until quiescent. With
            # several processes the "anyone flushed?" decision is global —
            # a process that flushed nothing still has to serve exchanges
            # for peers that did.
            flush_round = 1 << 40  # disjoint from the scheduler's rounds
            while True:
                flushed = False
                for node in sched.order:
                    flush = getattr(node, "flush", None)
                    if flush is None:
                        continue
                    rows = flush()
                    if rows:
                        from pathway_tpu_torch.engine.batch import Batch

                        t = max(sched.current_time + 1, 1)
                        sched.inject(
                            node, t, Batch.from_rows(node.column_names, rows)
                        )
                        flushed = True
                if exchange_ctx is not None:
                    states = exchange_ctx.control_allgather(flush_round, flushed)
                    flush_round += 1
                    flushed = any(states.values())
                if not flushed:
                    break
                sched.run()
        finally:
            for c in connectors:
                c.stop()
                # stop/close requests consumed by this run must not leak
                # into a later pw.run() on the same graph; requests issued
                # after this point (pre-start of the next run) survive
                c.reset_after_run()
            sched.teardown_exchanges()
            sched.shutdown()
            telemetry.shutdown()
            # drain the span flight recorder's buffered JSONL lines —
            # the run's serving/ingest spans are all finished by now
            from pathway_tpu_torch.engine import tracing

            tracing.flush_traces()
            sched.stats.finished = True
            self._stop_observers(monitor, metrics_server)
        if manager is not None:
            self._finish_persistence(manager, sched, connectors)
        for node in sched.order:
            finish = getattr(node, "finish", None)
            if finish is not None:
                finish()

    @staticmethod
    def _stop_observers(monitor, metrics_server) -> None:
        global METRICS_SERVER
        if monitor is not None:
            monitor.stop()
        if metrics_server is not None:
            metrics_server.stop()
            if METRICS_SERVER is metrics_server:
                METRICS_SERVER = None


def run(
    *,
    config: "config_mod.EngineConfig | None" = None,
    terminate_on_error: bool | None = None,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    persistence_config: Any = None,
    **kwargs: Any,
) -> None:
    """Execute the dataflow: pump all registered outputs until input ends.

    ``config`` holds the engine's switches (``EngineConfig()``'s defaults
    are the JAX flags' defaults; without one a run takes the default that
    :func:`config_default` installed, as a ``spawn`` child does);
    ``terminate_on_error`` overrides its field of that name, as JAX's
    argument does. ``monitoring_level`` is
    resolved as JAX resolves it (see ``internals/monitoring.py``): any
    level but ``NONE`` starts the live dashboard, which needs ``rich``.
    ``with_http_server=True`` serves the run's metrics on
    ``config.metrics_first_port + process_id``. ``persistence_config``
    (a ``pw.persistence.Config``) makes the run persistent; without one a
    run takes the default that :func:`persistence_default` installed (the
    CLI's ``replay``), else none. JAX arguments the port does not act on
    (``debug``, ``default_logging``, ``license_key``, ...) are accepted and
    ignored.
    """
    if persistence_config is None:
        persistence_config = _DEFAULT_PERSISTENCE
    cfg = config if config is not None else _DEFAULT_CONFIG or config_mod.EngineConfig()
    if terminate_on_error is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, terminate_on_error=terminate_on_error)
    targets = list(G.sinks)
    if not targets:
        return
    GraphRunner(targets, config=cfg, monitoring_level=monitoring_level,
                with_http_server=with_http_server,
                persistence_config=persistence_config).run()


@contextlib.contextmanager
def config_default(cfg):
    """Runs given no ``config`` (and the ``debug`` helpers' captures) take
    ``cfg`` while this holds: how the CLI's ``spawn`` hands each child its
    ``EngineConfig(processes=, process_id=, first_port=, threads=)``."""
    global _DEFAULT_CONFIG
    prev, _DEFAULT_CONFIG = _DEFAULT_CONFIG, cfg
    try:
        yield cfg
    finally:
        _DEFAULT_CONFIG = prev


@contextlib.contextmanager
def persistence_default(cfg):
    """Runs given no ``persistence_config`` take ``cfg`` while this holds
    (how the CLI's ``replay`` hands its Config to a program)."""
    global _DEFAULT_PERSISTENCE
    prev, _DEFAULT_PERSISTENCE = _DEFAULT_PERSISTENCE, cfg
    try:
        yield cfg
    finally:
        _DEFAULT_PERSISTENCE = prev


def run_all(**kwargs) -> None:
    run(**kwargs)


def capture_table(table, config=None) -> CaptureNode:
    """Attach (or reuse) a capture node for a table and run its subgraph."""
    node = CaptureNode(G.engine_graph, table._node)
    GraphRunner([node], config=config).run()
    return node
