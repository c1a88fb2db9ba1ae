"""The dataflow engine's switches (counterpart of the engine flags of
``pathway_tpu/internals/config.py``), as one value ``pw.run`` takes.

Each field is a JAX ``PATHWAY_*`` / ``PATHWAY_TPU_*`` flag with the JAX
default; the port reads no environment variable. ``pw.run(config=...)``
installs a config for that run and restores the one before it after;
``active()`` is what the scheduler and operators read while a run is on
(the defaults outside a run, e.g. for the ``debug`` helpers).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # PATHWAY_FUSION: stateless operator-chain fusion (graph.fuse_chains)
    fusion: bool = True
    # PATHWAY_TPU_COLUMNAR_SUBSCRIBE: subscribe callbacks formatted on a
    # background thread, one columnar block an epoch
    columnar_subscribe: bool = True
    # PATHWAY_TPU_DRAIN_COALESCE(_MAX): the deferred-UDF drainer merges
    # resolved chunks into one injected batch while the engine is behind
    drain_coalesce: bool = True
    drain_coalesce_max: int = 8
    # PATHWAY_TPU_EPOCH_CLOSEOUT: consolidation proofs ride column
    # transforms, and the end-of-epoch sweep visits only nodes with an
    # on_time_end
    epoch_closeout: bool = True
    # PATHWAY_TPU_OP_METRICS: per-operator registry telemetry
    op_metrics: bool = True
    # PATHWAY_TERMINATE_ON_ERROR: an ERROR value reaching an output aborts
    terminate_on_error: bool = True
    # PATHWAY_THREADS: operators of one topological level step in a pool
    threads: int = 1
    # PATHWAY_PROCESSES / PATHWAY_PROCESS_ID / PATHWAY_FIRST_PORT: the
    # run is one of ``processes`` processes on this host, which exchange
    # rows over a TCP mesh; process ``p`` listens on ``first_port + p``
    # (engine/exchange.py). A launcher's child builds these from its own
    # variables: the port reads none.
    processes: int = 1
    process_id: int = 0
    first_port: int = 10000

    def __post_init__(self):
        if self.drain_coalesce_max < 1:
            raise ValueError("drain_coalesce_max must be at least 1")
        if self.threads < 1:
            raise ValueError("threads must be at least 1")
        if self.processes < 1:
            raise ValueError("processes must be at least 1")
        if not 0 <= self.process_id < self.processes:
            raise ValueError(
                f"process_id must be in [0, {self.processes}), got {self.process_id}")
        if not 0 < self.first_port <= 65536 - self.processes:
            raise ValueError(f"first_port {self.first_port} leaves no room for "
                             f"{self.processes} ports")


_active = EngineConfig()


def active() -> EngineConfig:
    return _active


def install(config: EngineConfig) -> EngineConfig:
    """Make ``config`` the active one; returns the one it replaced."""
    global _active
    prev, _active = _active, config
    return prev
