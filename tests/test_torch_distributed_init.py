"""The port's ``initialize_distributed`` against JAX's contract
(``tests/test_distributed_init.py``): idempotent on the same topology, a
typed ``DistributedInitError`` on a conflicting one, a reset hook, and the
serving-mesh shape checked against the devices as a typed
``MeshShapeError``. The port takes the mesh shape as arguments
(``mesh=``, ``data=``, ``fsdp=``, ``tp=``, ``devices=``) where JAX reads
the ``PATHWAY_TPU_MESH*`` flags; ``devices`` is 8 virtual CPU positions,
the counterpart of the conftest's 8 host devices."""

import pytest
import torch

from pathway_tpu.parallel import distributed as JD
from pathway_tpu_torch.parallel import distributed as D
from pathway_tpu_torch.parallel.mesh import MeshShapeError, make_serving_mesh

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for name in ("PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_FIRST_PORT",
                 "PATHWAY_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    D.reset_distributed()
    yield
    D.reset_distributed()


def test_single_process_init_records_topology():
    assert D.distributed_topology() is None
    D.initialize_distributed()
    topo = D.distributed_topology()
    assert topo is not None and topo.num_processes == 1


def test_reinit_same_topology_is_noop():
    cfg = D.DistributedConfig(num_processes=1, process_id=0, coordinator_address=None)
    D.initialize_distributed(cfg)
    D.initialize_distributed(cfg)
    D.initialize_distributed()  # from_env resolves to the same thing
    assert D.distributed_topology() == cfg


def test_reinit_conflicting_topology_raises_typed_error():
    D.initialize_distributed()
    active = D.distributed_topology()
    conflicting = D.DistributedConfig(num_processes=4, process_id=2,
                                      coordinator_address="127.0.0.1:12345")
    with pytest.raises(D.DistributedInitError) as exc_info:
        D.initialize_distributed(conflicting)
    err = exc_info.value
    assert isinstance(err, RuntimeError)
    assert err.active == active and err.requested == conflicting
    assert "already initialized" in str(err)
    assert D.distributed_topology() == active


def test_reset_allows_reinitialization():
    D.initialize_distributed()
    D.reset_distributed()
    assert D.distributed_topology() is None
    cfg = D.DistributedConfig(num_processes=1, process_id=0,
                              coordinator_address="127.0.0.1:55555")
    D.initialize_distributed(cfg)
    assert D.distributed_topology() == cfg


def test_exported_from_parallel_package():
    import pathway_tpu_torch.parallel as P

    assert P.DistributedInitError is D.DistributedInitError
    assert P.reset_distributed is D.reset_distributed
    assert P.distributed_topology is D.distributed_topology


def test_from_env_reads_jax_process_contract(monkeypatch):
    """The reference's process variables, read as JAX's config reads them
    (JAX's process id is a field fixed when its config is built, so it is
    checked against the variable alone)."""
    monkeypatch.setenv("PATHWAY_PROCESSES", "4")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "2")
    monkeypatch.setenv("PATHWAY_FIRST_PORT", "23456")
    want = JD.DistributedConfig.from_env()
    got = D.DistributedConfig.from_env()
    assert (got.num_processes, got.coordinator_address) == \
        (want.num_processes, want.coordinator_address) == (4, "127.0.0.1:23456")
    assert got.process_id == 2
    monkeypatch.setenv("PATHWAY_COORDINATOR", "10.0.0.1:999")
    assert D.DistributedConfig.from_env().coordinator_address == "10.0.0.1:999"


# ---- the serving-mesh shape vs the topology ---------------------------------


def test_mesh_off_skips_agreement_check():
    D.initialize_distributed(mesh=False, data=13, devices=CPU8)  # absurd, gated
    D.validate_mesh_topology(mesh=False, data=13, devices=CPU8)


def test_mesh_agreeing_shape_initializes():
    D.initialize_distributed(mesh=True, data=2, fsdp=2, tp=2, devices=CPU8)
    assert D.distributed_topology() is not None


def test_mesh_auto_tp_fills_remaining_devices():
    D.initialize_distributed(mesh=True, data=2, fsdp=1, tp=0, devices=CPU8)
    assert make_serving_mesh(CPU8, data=2, fsdp=1, tp=0).shape["tp"] == 4


def test_mesh_impossible_shape_raises_typed_error():
    with pytest.raises(MeshShapeError) as exc_info:
        D.initialize_distributed(mesh=True, data=3, devices=CPU8)
    err = exc_info.value
    assert isinstance(err, ValueError)
    assert err.data == 3 and err.n_devices == 8
    assert "process" in str(err)
    # the failed bootstrap records no topology: a fixed shape re-inits
    assert D.distributed_topology() is None
    D.initialize_distributed(mesh=True, data=2, devices=CPU8)


def test_mesh_overcommitted_shape_raises_typed_error():
    with pytest.raises(MeshShapeError):
        D.validate_mesh_topology(mesh=True, data=4, fsdp=4, tp=4, devices=CPU8)


def _join(rank: int, port: int, out) -> None:
    """One of two processes: join over gloo, all-reduce its rank + 1."""
    import torch.distributed as dist

    D.initialize_distributed(D.DistributedConfig(2, rank, f"127.0.0.1:{port}"))
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    out.put((rank, float(t)))
    dist.destroy_process_group()


def test_two_processes_join_over_gloo():
    """Several processes join torch.distributed (gloo on the CPU) with the
    coordinator address of the config; every wait is bounded."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_join, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(out.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert got == [(0, 3.0), (1, 3.0)]
    assert all(p.exitcode == 0 for p in procs)
