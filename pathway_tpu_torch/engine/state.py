"""Sharding-aware device state (counterpart of the helpers at the end of
``pathway_tpu/engine/state.py``).

Device state (serving pools, param trees) crosses the host boundary in two
directions: gathered to the host for snapshots and checkpoints, and placed
on a mesh for a restore. These two helpers are that seam, so state moved
across a topology change always means "the gathered bytes were identical,
only the placement changed". The rest of JAX's ``engine/state.py`` (the
operator state of the dataflow engine) is not ported yet.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.parallel.mesh import ShardedTensor, place_pytree


def host_state_pytree(tree):
    """Every tensor leaf of a nested dict on the host: sharded leaves
    gathered across their shards, device leaves copied to CPU tensors.
    Other leaves pass through. The result is topology-free."""
    if isinstance(tree, dict):
        return {k: host_state_pytree(v) for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        return tree.gather().cpu()
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return tree


def place_state_pytree(tree, mesh=None, specs=None):
    """Place a host state tree onto a serving mesh with per-leaf
    ``PartitionSpec``s (replicated where unspecified); ``mesh=None``
    returns the tree untouched."""
    return place_pytree(tree, mesh, specs)
