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
as in JAX. Persistence is not carried (ROADMAP A13).
"""

from __future__ import annotations

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


class GraphRunner:
    def __init__(self, targets: list[Node], *, config=None, monitoring_level=None,
                 with_http_server: bool = False):
        self.targets = targets
        self.config = config if config is not None else config_mod.active()
        self.monitoring_level = monitoring_level
        self.with_http_server = with_http_server

    def run(self) -> None:
        prev = config_mod.install(self.config)
        try:
            self._run()
        finally:
            config_mod.install(prev)

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
        for c in connectors:
            c.start(sched)
        try:
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
            # drain the span flight recorder's buffered JSONL lines —
            # the run's serving/ingest spans are all finished by now
            from pathway_tpu_torch.engine import tracing

            tracing.flush_traces()
            sched.stats.finished = True
            self._stop_observers(monitor, metrics_server)
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
    **kwargs: Any,
) -> None:
    """Execute the dataflow: pump all registered outputs until input ends.

    ``config`` holds the engine's switches (``EngineConfig()``'s defaults
    are the JAX flags' defaults); ``terminate_on_error`` overrides its
    field of that name, as JAX's argument does. ``monitoring_level`` is
    resolved as JAX resolves it (see ``internals/monitoring.py``): any
    level but ``NONE`` starts the live dashboard, which needs ``rich``.
    ``with_http_server=True`` serves the run's metrics on
    ``config.metrics_first_port + process_id``. JAX arguments the port
    does not act on (``debug``, ``default_logging``, ``license_key``, ...)
    are accepted and ignored; ``persistence_config`` raises, since nothing
    here would honour it.
    """
    if kwargs.get("persistence_config"):
        raise NotImplementedError(
            "pw.run(persistence_config=...) is not carried by the port yet (ROADMAP A13)")
    cfg = config if config is not None else config_mod.EngineConfig()
    if terminate_on_error is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, terminate_on_error=terminate_on_error)
    targets = list(G.sinks)
    if not targets:
        return
    GraphRunner(targets, config=cfg, monitoring_level=monitoring_level,
                with_http_server=with_http_server).run()


def run_all(**kwargs) -> None:
    run(**kwargs)


def capture_table(table, config=None) -> CaptureNode:
    """Attach (or reuse) a capture node for a table and run its subgraph."""
    node = CaptureNode(G.engine_graph, table._node)
    GraphRunner([node], config=config).run()
    return node
