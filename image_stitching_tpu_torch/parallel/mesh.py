"""Device grids for scale-out (port of `parallel/mesh.py`).

Two axes, as in the reference: ``dp`` spreads images, pairs or whole
stitches over devices, ``sp`` spreads the panorama canvas.  A `Mesh` is a
numpy object array of `torch.device` with axis names; nothing runs on it
by itself.  The code that takes a mesh (`parallel/batched.py`,
`parallel/canvas.py`, `pipeline/compose_fused.py::fused_compose_sharded`)
runs each shard on its device, one after another from the host, and
gathers the shards.  A device may stand in several places, so
`[torch.device("cpu")] * 8` or `[torch.device("cuda", 0)] * 4` runs 8 or 4
shards on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "shard_batch",
           "local_devices", "on_device"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: object array of torch.device, one axis per name."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis (the
        one replica of each shard that computes it)."""
        ax = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            idx[ax] = i
            out.append(self.devices[tuple(idx)])
        return out


class P(tuple):
    """PartitionSpec: the mesh axis (or None) of each tensor dimension."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor laid out over `mesh` by `spec`: dimension 0 split into
    equal parts over the axis spec[0], the rest replicated."""

    mesh: Mesh
    spec: P

    def shard(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x's parts along dimension 0, each on its device."""
        devs = self.mesh.axis_devices(self.spec[0])
        if x.shape[0] % len(devs):
            raise ValueError(f"batch {x.shape[0]} does not divide over the "
                             f"{len(devs)} devices of axis {self.spec[0]!r}")
        return [c.to(d) for c, d in zip(x.chunk(len(devs)), devs)]


def on_device(dev: torch.device):
    """The context of one shard's work: its CUDA device current (kernels
    launch on the current device), nothing for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """This process's devices of a type: every CUDA device, or the CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp", "sp"),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (default: every CUDA device; raises when there
    is none, and never falls back to the CPU).  Default shape: all devices
    on the first axis, 1 on the others; an explicit shape takes the first
    prod(shape) devices.  The list may name a device several times."""
    if devices is None:
        devices = local_devices("cuda")
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "to build a mesh of other devices")
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    count = int(np.prod(shape))
    if count > len(devices) or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} over axes "
                         f"{tuple(axis_names)} needs {count} devices, "
                         f"{len(devices)} given")
    arr = np.empty(count, dtype=object)
    arr[:] = devices[:count]
    return Mesh(arr.reshape(shape), tuple(axis_names))


def shard_batch(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """The layout of a leading batch axis over `axis`."""
    return NamedSharding(mesh, P(axis))
