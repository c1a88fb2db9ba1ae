"""pathway_tpu_torch.parallel — device meshes, sharded state, collectives
(counterpart of ``pathway_tpu.parallel``).

The mesh is single-controller: one process drives every mesh position, a
:class:`ShardedTensor` holds one tensor per position, and per-shard work
runs once per distinct shard. Positions may repeat a device (virtual
shards). ``serving_mesh_from_flags`` is not ported: the port reads no flag,
and its meshes come in through constructor arguments (``mesh=``).
"""

from pathway_tpu_torch.parallel.mesh import (
    Mesh,
    MeshShapeError,
    NamedSharding,
    P,
    PartitionSpec,
    ShardedTensor,
    all_gather,
    all_reduce_sum,
    data_axis,
    local_mesh,
    make_mesh,
    make_serving_mesh,
    mesh_is_trivial,
    place_pytree,
    replicated,
    shard_batch,
    spec_dropping_nondividing,
    spec_with_fsdp,
    tensor_axis,
)
from pathway_tpu_torch.parallel.sharded_knn import ShardedKnnIndex, sharded_topk_merge
from pathway_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex, sharded_ivf_topk_merge
from pathway_tpu_torch.parallel.distributed import (
    DistributedConfig,
    DistributedInitError,
    distributed_topology,
    initialize_distributed,
    reset_distributed,
    validate_mesh_topology,
)
from pathway_tpu_torch.parallel.ring_attention import (
    encode_sequence_parallel,
    ring_attention_core,
)

__all__ = [
    "make_mesh",
    "data_axis",
    "tensor_axis",
    "local_mesh",
    "shard_batch",
    "replicated",
    "MeshShapeError",
    "make_serving_mesh",
    "mesh_is_trivial",
    "spec_dropping_nondividing",
    "spec_with_fsdp",
    "place_pytree",
    "Mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardedTensor",
    "all_gather",
    "all_reduce_sum",
    "ShardedKnnIndex",
    "sharded_topk_merge",
    "ShardedIvfIndex",
    "sharded_ivf_topk_merge",
    "DistributedConfig",
    "DistributedInitError",
    "distributed_topology",
    "initialize_distributed",
    "reset_distributed",
    "validate_mesh_topology",
    "ring_attention_core",
    "encode_sequence_parallel",
]
