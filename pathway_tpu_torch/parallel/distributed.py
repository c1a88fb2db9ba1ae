"""Multi-process bootstrap (counterpart of
``pathway_tpu/parallel/distributed.py``).

The mesh in :mod:`parallel.mesh` is single-controller: one process drives
every position, so a single process needs no runtime at all. Several
processes join through ``torch.distributed`` (gloo on the CPU, nccl on
CUDA), with the reference's environment contract, the names JAX's
``pathway_config`` reads:

    PATHWAY_PROCESSES    total processes
    PATHWAY_PROCESS_ID   this process's rank
    PATHWAY_FIRST_PORT   coordinator port base
    PATHWAY_COORDINATOR  coordinator ``host:port`` (overrides the port)

The serving mesh's shape comes in as arguments (JAX reads the
``PATHWAY_TPU_MESH*`` flags): :func:`validate_mesh_topology` checks that
``data * fsdp * tp`` factors the devices the topology exposes.
"""

from __future__ import annotations

import dataclasses

import torch

_DEFAULT_FIRST_PORT = 10000


@dataclasses.dataclass
class DistributedConfig:
    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str | None = None

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        from pathway_tpu_torch.internals.config import launcher_env

        n = int(launcher_env("PATHWAY_PROCESSES") or 1)
        port = int(launcher_env("PATHWAY_FIRST_PORT") or _DEFAULT_FIRST_PORT)
        addr = launcher_env("PATHWAY_COORDINATOR") or (
            f"127.0.0.1:{port}" if n > 1 else None)
        return cls(num_processes=n,
                   process_id=int(launcher_env("PATHWAY_PROCESS_ID") or 0),
                   coordinator_address=addr)


class DistributedInitError(RuntimeError):
    """A second :func:`initialize_distributed` asked for a topology that
    conflicts with the one already initialized (a process group cannot
    re-join another cluster). Carries both configs."""

    def __init__(self, active: DistributedConfig, requested: DistributedConfig):
        self.active = active
        self.requested = requested
        super().__init__(
            f"distributed runtime already initialized with {active}; "
            f"conflicting re-initialization requested with {requested} "
            f"(tear the process down, or call reset_distributed() in tests)")


_initialized: DistributedConfig | None = None


def initialize_distributed(config: DistributedConfig | None = None, *,
                           mesh: bool = False, data: int = 1, fsdp: int = 1,
                           tp: int = 0, devices=None) -> None:
    """Idempotent bootstrap; a no-op runtime in one process.

    The same topology again is a no-op; a different one raises
    :class:`DistributedInitError`. Several processes join
    ``torch.distributed`` (nccl when CUDA is available, else gloo). With
    ``mesh`` the serving-mesh shape is validated against the devices
    first (:func:`validate_mesh_topology`); a failure records nothing."""
    global _initialized
    cfg = config or DistributedConfig.from_env()
    if _initialized is not None:
        if cfg != _initialized:
            raise DistributedInitError(_initialized, cfg)
        return
    validate_mesh_topology(cfg, mesh=mesh, data=data, fsdp=fsdp, tp=tp, devices=devices)
    if cfg.num_processes > 1:
        import torch.distributed as dist

        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{cfg.coordinator_address}",
            world_size=cfg.num_processes, rank=cfg.process_id)
    _initialized = cfg


def validate_mesh_topology(config: DistributedConfig | None = None, *,
                           mesh: bool = False, data: int = 1, fsdp: int = 1,
                           tp: int = 0, devices=None) -> None:
    """The serving-mesh shape and the devices must agree: ``data * fsdp *
    tp`` factors ``devices`` (default: the visible CUDA devices), with
    ``tp=0`` taking the rest. An impossible request raises the typed
    :class:`~pathway_tpu_torch.parallel.mesh.MeshShapeError` here,
    annotated with the topology. No-op with ``mesh`` off."""
    from pathway_tpu_torch.parallel.mesh import MeshShapeError, make_serving_mesh

    if not mesh:
        return
    cfg = config or _initialized or DistributedConfig.from_env()
    try:
        make_serving_mesh(devices, data=data, fsdp=fsdp, tp=tp)
    except MeshShapeError as err:
        raise MeshShapeError(
            f"the serving mesh disagrees with the topology: "
            f"{cfg.num_processes} process(es) expose {err.n_devices} device(s), "
            f"but the mesh shape requested an impossible factoring",
            data=err.data, fsdp=err.fsdp, tp=err.tp, n_devices=err.n_devices,
        ) from err


def distributed_topology() -> DistributedConfig | None:
    """The topology this process initialized with, None before."""
    return _initialized


def reset_distributed() -> None:
    """Test hook: forget the recorded topology. A live process group stays
    (only meaningful in single-process tests)."""
    global _initialized
    _initialized = None
