"""Batched camera model: a dataclass of tensors (port of `geometry/camera.py`).

`Cameras` holds N cameras' intrinsics and rotations stacked on a leading
axis, like cv::detail::CameraParams per image; K = [[f, 0, ppx],
[0, f * aspect, ppy], [0, 0, 1]].
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["Cameras", "make_k", "get_fov"]


@dataclasses.dataclass(frozen=True)
class Cameras:
    """focal, aspect, ppx, ppy: (N,) float32; R: (N, 3, 3); t: (N, 3)."""

    focal: torch.Tensor
    aspect: torch.Tensor
    ppx: torch.Tensor
    ppy: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor

    @classmethod
    def from_numpy(cls, focal, aspect, ppx, ppy, R, t,
                   device="cuda") -> "Cameras":
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return cls(f32(focal), f32(aspect), f32(ppx), f32(ppy), f32(R),
                   f32(t))

    @classmethod
    def identity(cls, n: int, focal: float = 1.0,
                 device="cuda") -> "Cameras":
        """n cameras of one focal, unit aspect, principal point 0 and
        rotation I."""
        return cls.from_numpy(np.full(n, focal), np.ones(n), np.zeros(n),
                              np.zeros(n), np.tile(np.eye(3), (n, 1, 1)),
                              np.zeros((n, 3)), device=device)

    @property
    def device(self) -> torch.device:
        return self.focal.device

    def __len__(self) -> int:
        return int(self.focal.shape[0])

    def __getitem__(self, idx) -> "Cameras":
        if not isinstance(idx, torch.Tensor):
            idx = torch.as_tensor(np.asarray(idx), device=self.device)
        return Cameras(*(getattr(self, f.name)[idx]
                         for f in dataclasses.fields(self)))

    def K(self) -> torch.Tensor:
        return make_k(self.focal, self.aspect, self.ppx, self.ppy)

    def scaled(self, scale: float) -> "Cameras":
        """Scale focal/ppx/ppy (the work/seam/compose rescale)."""
        return dataclasses.replace(self, focal=self.focal * scale,
                                   ppx=self.ppx * scale, ppy=self.ppy * scale)

    def numpy(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}


def make_k(focal, aspect, ppx, ppy) -> torch.Tensor:
    """(..., 3, 3) intrinsics from (...,) fields."""
    zero = torch.zeros_like(focal)
    one = torch.ones_like(focal)
    row0 = torch.stack([focal, zero, ppx * one], dim=-1)
    row1 = torch.stack([zero, focal * aspect, ppy * one], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def get_fov(cam: Cameras):
    """(fov_x, fov_y) in radians by the reference's formula
    (`image_stitching.cpp:175-186`): 2 atan(pp / f) per axis."""
    k = cam.K()
    return (2.0 * torch.arctan(cam.ppx / k[..., 0, 0]),
            2.0 * torch.arctan(cam.ppy / k[..., 1, 1]))
