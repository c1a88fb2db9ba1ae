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
    # PATHWAY_PROCESSES: several processes exchange rows (not ported:
    # anything but 1 raises, see ROADMAP A13)
    processes: int = 1

    def __post_init__(self):
        if self.drain_coalesce_max < 1:
            raise ValueError("drain_coalesce_max must be at least 1")
        if self.threads < 1:
            raise ValueError("threads must be at least 1")
        if self.processes != 1:
            raise NotImplementedError(
                "processes > 1 needs the engine's row exchange between "
                "processes (engine/exchange.py), which the port does not "
                "carry yet: ROADMAP A13")


_active = EngineConfig()


def active() -> EngineConfig:
    return _active


def install(config: EngineConfig) -> EngineConfig:
    """Make ``config`` the active one; returns the one it replaced."""
    global _active
    prev, _active = _active, config
    return prev
