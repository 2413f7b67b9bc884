"""Data parallelism on ``torch.distributed``: the port's distributed backend.

Port of ``neural_ldpc_tpu/parallel/mesh.py``.  JAX shards the codeword
batch over a device mesh ('data' axis) and lets XLA insert the psums; here
each rank is one process holding one device, the batch is split by rows,
params are replicated, and the reductions are explicit collectives: NCCL
between cards, gloo on the CPU and for ranks that share one card (NCCL
refuses two ranks on one card).  Gloo takes CUDA tensors only in
``all_reduce`` and ``broadcast``, staging them through the host, so those
are the only collectives used.

The collectives run after the kernels that produced their inputs: the
kernels launch on ``torch.cuda.current_stream``, and both NCCL and gloo's
CUDA path make their work wait on that stream before reading a tensor.

Multi-process runs join the group with ``initialize_distributed`` (from
``torchrun``'s environment, or from explicit arguments) before
``make_mesh``; ``make_mesh(1)`` without a group builds a real one-rank
group, so a mesh of one runs the same collectives as a mesh of many.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import socket
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"

# a collective that one rank never joins (a mismatched loop bound, a rank
# that died) fails after this long instead of hanging
TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: this process's place in the group."""

    axis_name: str
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
):
    """Join the process group (a no-op for one process or none, and where
    the group exists already).  Without arguments the group is the one
    ``torchrun`` describes (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``).  The backend defaults to NCCL where
    a card is present and gloo otherwise; under NCCL each process takes the
    card of its local rank."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"]) if process_id is None else process_id
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a group of several processes needs coordinator_address and process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        count = torch.cuda.device_count()
        local = int(env.get("LOCAL_RANK", process_id))
        if local >= count:
            raise ValueError(f"requested {local + 1} devices, have {count}")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the group (``n_devices``, when given,
    must equal its size).  Without a group, a one-rank group on the
    device's backend is created first."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} devices, have 1")
        dist.init_process_group(default_backend(dev), store=dist.HashStore(), world_size=1,
                                rank=0, timeout=TIMEOUT)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, have {size}")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if dist.get_backend() == "nccl" and size > count:
            # NCCL refuses two ranks on one card ("Duplicate GPU detected")
            raise ValueError(f"requested {size} devices, have {count}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis_name, dist.group.WORLD, rank, size, dev)


def data_sharding(mesh: Mesh, axis_name: str = DATA_AXIS):
    """The batch's placement: rows split over the ranks (not used on the
    hot path, which splits by ``shard_batch``)."""
    from torch.distributed.tensor import Shard

    return Shard(0)


def replicated_sharding(mesh: Mesh):
    """The params' placement: a full copy on every rank."""
    from torch.distributed.tensor import Replicate

    return Replicate()


def _rows(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch_size {n} not divisible by {mesh.size} mesh devices")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def shard_batch(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """This rank's rows ``[r·B/n, (r+1)·B/n)`` of a batch-leading tensor (or
    array, or dict of them)."""
    if isinstance(x, dict):
        return {k: _rows(v, mesh) for k, v in x.items()}
    return _rows(x, mesh)


def _flat_groups(tensors: dict):
    """Keys in sorted order, grouped by dtype: one buffer (one collective)
    per dtype."""
    groups: dict = {}
    for k in sorted(tensors):
        groups.setdefault(tensors[k].dtype, []).append(k)
    return groups


def _collective(x, mesh: Mesh, fn):
    """Apply ``fn(buffer)`` (an in-place collective) to a tensor, or to a
    dict flattened into one buffer per dtype; returns new tensors."""
    if not isinstance(x, dict):
        buf = x.detach().clone()
        fn(buf)
        return buf
    out = {}
    for _, keys in _flat_groups(x).items():
        buf = torch.cat([x[k].detach().reshape(-1) for k in keys])
        fn(buf)
        off = 0
        for k in keys:
            n = x[k].numel()
            out[k] = buf[off:off + n].view(x[k].shape)
            off += n
    return out


def replicate(x, mesh: Mesh):
    """Rank 0's tensor (or dict of tensors) on every rank."""
    return _collective(x, mesh, lambda b: dist.broadcast(b, src=0, group=mesh.group))


def all_reduce_sum(x, mesh: Mesh):
    return _collective(x, mesh, lambda b: dist.all_reduce(b, dist.ReduceOp.SUM, group=mesh.group))


def all_reduce_max(x, mesh: Mesh):
    return _collective(x, mesh, lambda b: dist.all_reduce(b, dist.ReduceOp.MAX, group=mesh.group))


def all_reduce_mean(x, mesh: Mesh):
    """The sum over the ranks divided by their number (gloo has no AVG);
    on one rank the values come back unchanged, bit for bit."""
    def mean(b):
        dist.all_reduce(b, dist.ReduceOp.SUM, group=mesh.group)
        b.div_(mesh.size)
    return _collective(x, mesh, mean)


def barrier(mesh: Mesh) -> None:
    """Return once every rank has reached this point (the result is read on
    the host, so an NCCL reduction cannot leave a rank running ahead)."""
    all_reduce_sum(torch.zeros(1, device=mesh.device), mesh).item()


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _rank_main(rank: int, n: int, port: int, module: str, argv: list) -> None:
    os.environ.update(WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    importlib.import_module(module).main(argv)


def run_with_mesh(module: str, argv, n_devices: Optional[int], device, run):
    """``run(mesh)`` for a command line with ``--mesh-devices n_devices``:
    ``run(None)`` without one; under ``torchrun`` this process's rank of its
    group (``WORLD_SIZE`` must equal ``n_devices``); without a launcher,
    ``n_devices`` > 1 starts that many local processes, each running
    ``module.main(argv)`` with the environment ``torchrun`` would give it
    (a free localhost port), and raises if one fails.  A group this call
    created is destroyed on exit."""
    if not n_devices:
        return run(None)
    world = os.environ.get("WORLD_SIZE")
    if world is None and n_devices > 1:
        import torch.multiprocessing as mp

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(_rank_main, args=(n_devices, port, module, list(argv)),
                           nprocs=n_devices, start_method="spawn")
        return 0
    if world is not None and int(world) != n_devices:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    created = not dist.is_initialized()
    initialize_distributed(backend=default_backend(device))
    try:
        return run(make_mesh(n_devices, device=device))
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
