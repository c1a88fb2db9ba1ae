"""``pw.run`` and the graph runner.

Parity with reference ``internals/run.py`` + ``graph_runner/__init__.py``:
tree-shakes the engine graph from requested outputs, resets run-scoped state,
feeds static sources, starts connector threads and pumps the scheduler until
the frontier closes (or forever for unbounded streaming inputs).

The port runs one process. The engine's switches are one
``EngineConfig`` (``internals/config.py``) that ``run(config=...)`` takes;
persistence, the terminal monitor and the HTTP metrics server of the JAX
runner are not carried (ROADMAP A13). A run whose monitoring level
resolves to ``MonitoringLevel.NONE`` (what the REST servers pass) needs
no monitor and runs.
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


class GraphRunner:
    def __init__(self, targets: list[Node], *, config=None):
        self.targets = targets
        self.config = config if config is not None else config_mod.active()

    def run(self) -> None:
        prev = config_mod.install(self.config)
        try:
            self._run()
        finally:
            config_mod.install(prev)

    def _run(self) -> None:
        sched = Scheduler(G.engine_graph, self.targets, config=self.config)
        global LAST_RUN_STATS
        LAST_RUN_STATS = sched.stats
        involved = {n.id for n in sched.order}
        for node in sched.order:
            node.reset()
        static = [
            (node, provider)
            for node, provider in G.static_sources.values()
            if node.id in involved
        ]
        for node, _ in static:
            sched.register_source(node, 0)
        connectors = [c for c in G.connectors if c.node.id in involved]
        for c in connectors:
            sched.register_source(c.node, 0)
        for node, provider in static:
            batch = provider()
            if batch is not None and len(batch) > 0:
                sched.inject(node, 0, batch)
            sched.close_source(node)
        for c in connectors:
            c.start(sched)
        try:
            sched.run()
            # end-of-stream: flush buffers repeatedly until quiescent
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
            sched.shutdown()
            # drain the span flight recorder's buffered JSONL lines —
            # the run's serving/ingest spans are all finished by now
            from pathway_tpu_torch.engine import tracing

            tracing.flush_traces()
            sched.stats.finished = True
        for node in sched.order:
            finish = getattr(node, "finish", None)
            if finish is not None:
                finish()


def run(
    *,
    config: "config_mod.EngineConfig | None" = None,
    terminate_on_error: bool | None = None,
    **kwargs: Any,
) -> None:
    """Execute the dataflow: pump all registered outputs until input ends.

    ``config`` holds the engine's switches (``EngineConfig()``'s defaults
    are the JAX flags' defaults); ``terminate_on_error`` overrides its
    field of that name, as JAX's argument does. JAX arguments the port
    does not act on (``debug``, ``default_logging``, ...) are accepted and
    ignored. ``monitoring_level`` is resolved as JAX resolves it (see
    ``internals/monitoring.py``): a level that resolves to
    ``MonitoringLevel.NONE`` runs without a monitor, any other raises, as
    do ``persistence_config`` and ``with_http_server``, since nothing here
    would honour them.
    """
    for name in ("persistence_config", "with_http_server"):
        if kwargs.get(name):
            raise NotImplementedError(
                f"pw.run({name}=...) is not carried by the port yet (ROADMAP A13)")
    from pathway_tpu_torch.internals.monitoring import MonitoringLevel, resolve_level

    if resolve_level(kwargs.get("monitoring_level")) != MonitoringLevel.NONE:
        raise NotImplementedError(
            f"pw.run(monitoring_level={kwargs['monitoring_level']!r}) starts the live "
            "monitor, which the port does not carry yet (ROADMAP A13)")
    cfg = config if config is not None else config_mod.EngineConfig()
    if terminate_on_error is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, terminate_on_error=terminate_on_error)
    targets = list(G.sinks)
    if not targets:
        return
    GraphRunner(targets, config=cfg).run()


def run_all(**kwargs) -> None:
    run(**kwargs)


def capture_table(table, config=None) -> CaptureNode:
    """Attach (or reuse) a capture node for a table and run its subgraph."""
    node = CaptureNode(G.engine_graph, table._node)
    GraphRunner([node], config=config).run()
    return node
