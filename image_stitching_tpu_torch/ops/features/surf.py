"""SURF-family detector/descriptor (port of
`image_stitching_tpu/ops/features/surf.py`).

A determinant-of-Hessian stack over a Gaussian ladder of four scales,
the vector sum of gradients over a radius-9 disk for the orientation,
and the 64-dim descriptor: 4x4 cells of a rotated 20x20 window, per cell
[sum dx', sum |dx'|, sum dy', sum |dy'|] of the gradients rotated into
the keypoint frame, L2-normalised and L2-matched.  The gathers read
zero-padded gradient planes, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..imgproc import fma, gaussian_blur
from .hessian import central_grad, det_hessian, top_k_keypoints
from .types import Features

__all__ = ["surf_detect_and_describe", "disk_orientation"]

_SCALES = (1.2, 2.0, 3.2, 4.8)


def disk_orientation(gx: torch.Tensor, gy: torch.Tensor, xy: torch.Tensor,
                     radius: int, pad: int) -> torch.Tensor:
    """atan2 of the summed gradients over a radius-`radius` disk around
    each rounded keypoint, read from planes zero-padded by `pad`."""
    dev = gx.device
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = xs ** 2 + ys ** 2 <= radius * radius
    ox = torch.as_tensor(xs[disk], device=dev)
    oy = torch.as_tensor(ys[disk], device=dev)
    gxp, gyp = F.pad(gx, (pad,) * 4), F.pad(gy, (pad,) * 4)
    pts = torch.round(xy).to(torch.int64) + pad
    sy = pts[:, None, 1] + oy[None, :]
    sx = pts[:, None, 0] + ox[None, :]
    return torch.atan2(torch.sum(gyp[sy, sx], 1), torch.sum(gxp[sy, sx], 1))


def _descriptor_grid(dev):
    """The 20x20 window's pixel-centre offsets (S, 2) and their cells."""
    half = 10
    ys2, xs2 = np.mgrid[-half:half, -half:half] + 0.5
    offs = torch.as_tensor(np.stack([xs2.ravel(), ys2.ravel()], -1)
                           .astype(np.float32), device=dev)
    cell_x = np.clip(((xs2.ravel() + half) // 5).astype(np.int64), 0, 3)
    cell_y = np.clip(((ys2.ravel() + half) // 5).astype(np.int64), 0, 3)
    return offs, torch.as_tensor(cell_y * 4 + cell_x, device=dev)


def surf_detect_and_describe(gray: torch.Tensor,
                             n_features: int = 4000) -> Features:
    """Detect + describe one (H, W) image into `n_features` masked slots;
    desc is (K, 64) float32."""
    img = gray.to(torch.float32)
    dev = img.device
    maps = []
    for s in _SCALES:
        radius = max(1, min(int(2 * s), 8))
        maps.append(det_hessian(gaussian_blur(img, s, radius)) * (s ** 2))
    xy, resp, sc, valid = top_k_keypoints(maps, n_features, border=18)

    # Gradients of a mildly smoothed image drive orientation + descriptor.
    gx, gy = central_grad(gaussian_blur(img, 1.2, 3))
    angle = disk_orientation(gx, gy, xy, radius=9, pad=12)

    offs, cell = _descriptor_grid(dev)
    pad2 = 18
    gxp2, gyp2 = F.pad(gx, (pad2,) * 4), F.pad(gy, (pad2,) * 4)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    ox, oy = offs[None, :, 0], offs[None, :, 1]
    rx = fma(ca, ox, -(sa * oy))
    ry = fma(sa, ox, ca * oy)
    sxi = torch.round(xy[:, 0:1] + rx).to(torch.int64) + pad2
    syi = torch.round(xy[:, 1:2] + ry).to(torch.int64) + pad2
    gxs, gys = gxp2[syi, sxi], gyp2[syi, sxi]
    dx_r = fma(ca, gxs, sa * gys)
    dy_r = fma(-sa, gxs, ca * gys)
    idx = cell[None, :].expand(xy.shape[0], -1)

    def scatter(vals):
        return torch.zeros((vals.shape[0], 16), device=dev).scatter_add_(
            1, idx, vals)
    d = torch.cat([scatter(dx_r), scatter(torch.abs(dx_r)),
                   scatter(dy_r), scatter(torch.abs(dy_r))], dim=1)
    d = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-6)

    scale_vals = torch.as_tensor(_SCALES, dtype=torch.float32,
                                 device=dev)[sc.long()]
    return Features(xy=xy, response=torch.where(valid, resp, 0.0),
                    angle=angle, octave=sc, size=scale_vals * 9.0,
                    desc=d, valid=valid)
