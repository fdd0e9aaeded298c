"""The process group and the hybrid mesh, on ``torch.distributed``.

Counterpart of ``alifmm_tpu/parallel/multihost.py``.  The scale-out
ladder: one card solves a batch of sources; one process drives a mesh of
its own devices (``shard.solve_ttf_sharded`` / ``solve_ttf_halo``); many
processes join a group, the source batch is split across them and the
grid (halo exchanges every sweep) stays inside each process's devices.

The group uses NCCL where the process has a card and gloo on the CPU.
Its address, size and rank are passed in, or read from the environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, or a SLURM or
OpenMPI launch's task count and rank).  Nothing is detected beyond that:
a single-process run is a no-op.

Usage (the same program in every process)::

    from alifmm_tpu_torch.parallel import multihost, shard
    multihost.init("tcp://host:29500", num_processes=2, process_id=rank)
    mesh = multihost.hybrid_mesh()         # ("src", "gz") of this process
    ttfs = shard.solve_ttf_sharded(model, scx, scz, mesh, axis="src")
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from . import Mesh

__all__ = ["init", "is_initialized", "hybrid_mesh", "process_summary"]

_initialized = False
_init_result: bool | None = None
_local_devices = None
# how long a collective waits for the other processes before it fails
TIMEOUT_S = 120


def _env_int(env, *keys):
    """The first of ``keys`` in the environment that parses as an int."""
    for k in keys:
        try:
            return int(env[k])
        except (KeyError, ValueError):
            continue
    return None


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None,
         local_device_ids=None) -> bool:
    """Join the process group of a multi-process job.

    ``coordinator_address`` is ``tcp://host:port`` (the rank-0 process
    listens there); explicit arguments win over the environment.
    ``local_device_ids``: the CUDA devices of this process (all by
    default); NCCL runs on the first.

    Returns True when a group was set up, False for the single-process
    no-op (no address configured and no multi-task SLURM or OpenMPI
    launch).  Idempotent: a second call returns the first call's result,
    except that an explicit call after a no-op still initialises."""
    global _initialized, _init_result, _local_devices
    explicit_args = any(a is not None for a in (
        coordinator_address, num_processes, process_id, local_device_ids))
    if _init_result is not None and (_init_result or not explicit_args):
        return _init_result
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"tcp://{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    tasks = _env_int(env, "WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
                     "OMPI_COMM_WORLD_SIZE")
    if num_processes is None:
        num_processes = tasks
    if process_id is None:
        process_id = _env_int(env, "RANK", "SLURM_PROCID",
                              "OMPI_COMM_WORLD_RANK")
    # only a real multi-task launch counts: one task inside an allocation
    # (salloc without srun, a one-task array job) must not initialise
    auto = (tasks or 1) > 1
    if coordinator_address is None and not auto:
        _init_result = False
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise RuntimeError(
            "a multi-process launch needs the coordinator's tcp://host:port "
            "(coordinator_address or MASTER_ADDR/MASTER_PORT), the process "
            "count and this process's rank")
    import torch.distributed as dist

    if torch.cuda.is_available():
        ids = (list(local_device_ids) if local_device_ids is not None
               else list(range(torch.cuda.device_count())))
        _local_devices = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(_local_devices[0])
        backend = "nccl"
    else:
        _local_devices = None
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _initialized = True
    _init_result = True
    return True


def is_initialized() -> bool:
    """Whether init() set up a process group in this process."""
    return _initialized


def shutdown():
    """Leave the process group that init() joined (a no-op without one);
    init() may then join another."""
    global _initialized, _init_result
    if _initialized:
        import torch.distributed as dist

        dist.destroy_process_group()
    _initialized = False
    _init_result = None


def _world():
    """(rank, size) of the process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def hybrid_mesh(src_axis: str = "src", grid_axis: str = "gz",
                grid_per_host: int | None = None, devices=None) -> Mesh:
    """A (src, grid) mesh of this process's devices.

    ``grid_per_host`` devices of the process go to the grid (halo) axis,
    the chatty one, kept inside the process; the rest go to the source
    axis, which continues across the processes of the group (the sharded
    solves split the batch across processes first) and whose only traffic
    is one reduction a pass and the final gather.  Default: every local
    device on the grid axis in a multi-process run, a plain source mesh in
    a single process.  ``devices``: the local devices (every local CUDA
    device by default; raises RuntimeError without a card).  A size-1
    axis is kept, so callers can name both axes."""
    if devices is None:
        devices = _local_devices
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("hybrid_mesh needs a CUDA device, or the "
                               "devices passed in")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n_local = len(devices)
    n_proc = _world()[1]
    if grid_per_host is None:
        grid_per_host = n_local if n_proc > 1 else 1
    if n_local % grid_per_host:
        raise ValueError(f"grid_per_host={grid_per_host} does not divide the "
                         f"{n_local} local devices")
    arr = np.empty(n_local, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(n_local // grid_per_host, grid_per_host),
                (src_axis, grid_axis))


def process_summary() -> str:
    """One line on the group (for logs)."""
    rank, size = _world()
    if _local_devices is not None:
        n_local, kind = len(_local_devices), "cuda"
    elif torch.cuda.is_available():
        n_local, kind = torch.cuda.device_count(), "cuda"
    else:
        n_local, kind = 1, "cpu"
    return (f"process {rank}/{size}: {n_local} local / {n_local * size} "
            f"global {kind} devices")
