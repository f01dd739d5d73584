"""Multi-process scale-out over `torch.distributed` (port of
`parallel/distributed.py`).

Each process owns its devices and joins one process group.  The ``dp``
mesh axis spans the processes: whole pair batches split across them, and
the only traffic is the gather of the results.  The ``sp`` (canvas) axis
stays inside one process.  `init_distributed` starts the group (NCCL for
CUDA devices, gloo for the CPU), `make_global_mesh` lays the processes'
devices out, `shard_local_batch` places this process's rows in the global
batch, and `batched_register_distributed` registers them and gathers
every process's results.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, local_devices

__all__ = ["init_distributed", "make_global_mesh", "shard_local_batch",
           "batched_register_distributed", "ProcessBatch"]

# This process's devices, as init_distributed set them up.
_local = {"devices": None}


def _process_devices():
    if _local["devices"] is not None:
        return _local["devices"]
    return local_devices("cuda")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, device: str = "cuda") -> bool:
    """Join the process group: True when a multi-process group was started,
    False for a single process.

    num_processes <= 1 gives False.  With no address and no process count,
    a process started by torchrun (MASTER_ADDR in its environment) joins
    by the environment's rendezvous; a bare process, without MASTER_ADDR,
    stays single-process and returns False.  device "cuda" (the default)
    takes the NCCL backend and local_device_ids (default: LOCAL_RANK, else
    0) as this process's CUDA devices, and raises without CUDA; "cpu"
    takes gloo and len(local_device_ids) (default 1) CPU shards."""
    if num_processes is not None and num_processes <= 1:
        return False
    env = coordinator_address is None and num_processes is None
    if env and not os.environ.get("MASTER_ADDR"):
        return False
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device 'cuda' without a "
                               "CUDA device; pass device='cpu' for gloo")
        ids = (list(local_device_ids) if local_device_ids is not None
               else [int(os.environ.get("LOCAL_RANK", 0))])
        devices = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(devices[0])
        backend = "nccl"
    elif device == "cpu":
        n = len(local_device_ids) if local_device_ids is not None else 1
        devices = [torch.device("cpu")] * n
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: device {device!r} is neither "
                         "'cuda' nor 'cpu'")
    if env:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    _local["devices"] = devices
    return True


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class GlobalMesh(Mesh):
    """A mesh whose devices belong to several processes: ranks[i] is the
    process that owns devices[i]."""

    ranks: np.ndarray = None

    def local_axis_devices(self, axis: str):
        """This process's devices along `axis` (index 0 of the others)."""
        _, rank = _world()
        ax = self.axis_names.index(axis)
        sel = [0] * self.devices.ndim
        sel[ax] = slice(None)
        devs, owners = self.devices[tuple(sel)], self.ranks[tuple(sel)]
        return [d for d, r in zip(devs, owners) if r == rank]


def make_global_mesh(axis_names: Sequence[str] = ("dp", "sp"),
                     sp: int = 1, devices=None) -> GlobalMesh:
    """Mesh over every process's devices: dp rows span the processes, the
    sp axis holds devices of one process.  `devices` are this process's
    (default: those init_distributed set up, else every CUDA device);
    every process holds as many.  sp must divide that count."""
    world, _ = _world()
    devices = list(devices) if devices is not None else _process_devices()
    per_proc = len(devices)
    if sp <= 0 or per_proc % sp != 0:
        raise ValueError(
            f"sp={sp} must divide the per-process device count {per_proc} "
            "(the canvas axis must stay on one host's ICI)")
    # Another process's devices are named as it names them (the same list).
    flat = np.empty(world * per_proc, dtype=object)
    flat[:] = [d for _ in range(world) for d in devices]
    ranks = np.repeat(np.arange(world), per_proc)
    shape = (world * per_proc // sp, sp)
    return GlobalMesh(flat.reshape(shape), tuple(axis_names),
                      ranks.reshape(shape))


@dataclasses.dataclass(frozen=True)
class ProcessBatch:
    """This process's rows of a global batch split evenly over the
    processes: rows (n, ...) at global rows [offset, offset + n) of
    `global_size`."""

    rows: torch.Tensor
    offset: int
    global_size: int


def shard_local_batch(mesh: GlobalMesh, local_batch, axis: str = "dp"):
    """This process's slice of a dp-split global batch, with its place:
    process p of P feeding n rows holds global rows [p n, (p + 1) n)."""
    world, rank = _world()
    rows = torch.as_tensor(np.asarray(local_batch))
    return ProcessBatch(rows, rank * rows.shape[0], world * rows.shape[0])


def batched_register_distributed(mesh: GlobalMesh, hw: Tuple[int, int],
                                 n_features: int = 1024,
                                 match_conf: float = 0.32,
                                 n_hyp: int = 512):
    """Multi-process batched pair registration.  Returns fn(pairs, keys),
    both ProcessBatch from `shard_local_batch` (pairs (n, 2, H, W), keys
    the (n, 2) threefry keys of those pairs, this process's rows of the
    global batch's keys): this process registers its own rows on its dp
    devices (`parallel/batched.py::make_batched_register`), then the
    processes' results are gathered, so every process returns the global
    (h (B, 3, 3), confidence (B,), n_inliers (B,)); its own rows are
    [pairs.offset, pairs.offset + n)."""
    from .batched import make_batched_register
    from .mesh import make_mesh
    local = make_mesh(devices=mesh.local_axis_devices("dp"))
    fn_local = make_batched_register(local, hw, n_features=n_features,
                                     match_conf=match_conf, n_hyp=n_hyp)

    def fn(pairs: ProcessBatch, keys: ProcessBatch):
        outs = fn_local(pairs.rows, keys.rows)
        world, _ = _world()
        if world == 1:
            return outs
        gathered = []
        for x in outs:
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x.contiguous())
            gathered.append(torch.cat(parts))
        return tuple(gathered)
    return fn
