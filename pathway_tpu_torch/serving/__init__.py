"""The replicated serving fleet of the port (counterpart of
``pathway_tpu/serving/``).

* :mod:`~pathway_tpu_torch.serving.hashring`: the consistent-hash ring,
  keyed on prompt-head token blocks of the replicas' prefix-cache block;
* :mod:`~pathway_tpu_torch.serving.replica`: :class:`InProcessReplica`, a
  continuous ``DecoderChat`` of this process as a fleet member, and
  :class:`HttpReplica`, a replica process of its own behind its REST routes
  (:func:`spawn_replica_process`; ``python -m pathway_tpu_torch fleet
  serve`` runs such a fleet);
* :mod:`~pathway_tpu_torch.serving.router`: :class:`FleetRouter` (affinity
  routing, failover, in-flight re-queue) and :class:`RouterServer`;
* :mod:`~pathway_tpu_torch.serving.fleet`: :class:`FleetManager` (health,
  drain and respawn, SLO elasticity).

The fleet is off by default, as ``PATHWAY_TPU_FLEET`` is in JAX:
:func:`build_fleet` constructs nothing until :func:`configure` turns it
on.
"""

from __future__ import annotations

from pathway_tpu_torch.serving.fleet import FleetManager
from pathway_tpu_torch.serving.hashring import HashRing, affinity_block_tokens, head_block_key
from pathway_tpu_torch.serving.replica import (
    HttpReplica,
    InProcessReplica,
    ReplicaError,
    free_port,
    spawn_replica_process,
)
from pathway_tpu_torch.serving.router import FleetCompletion, FleetRouter, RouterServer

_enabled = False


def configure(enabled: bool = False) -> None:
    """Turn the fleet on or off for :func:`build_fleet` (default off, the
    JAX flag default)."""
    global _enabled
    _enabled = bool(enabled)


def fleet_enabled() -> bool:
    return _enabled


def build_fleet(factory, **kwargs):
    """A started :class:`FleetManager` over ``factory`` (``kwargs`` go to
    its constructor), or None while the fleet is off: then no ring, router
    or manager is built and the factory is never called."""
    if not _enabled:
        return None
    return FleetManager(factory, **kwargs).start()


__all__ = [
    "FleetCompletion",
    "FleetManager",
    "FleetRouter",
    "HashRing",
    "HttpReplica",
    "InProcessReplica",
    "ReplicaError",
    "RouterServer",
    "affinity_block_tokens",
    "build_fleet",
    "configure",
    "fleet_enabled",
    "free_port",
    "head_block_key",
    "spawn_replica_process",
]
