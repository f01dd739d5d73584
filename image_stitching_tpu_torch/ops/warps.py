"""Spherical rotation warper (port of the spherical parts of `ops/warps.py`).

ROI detection is host numpy in float32, copied from the reference so the
integer rectangles agree exactly (border scan, date-line rebranch, pole
fix).  The backward map from warped-plane coordinates to source pixels is
torch, in the separable form: on an axis-aligned grid the ray factors into
functions of u alone and v alone, so the transcendentals are O(W + H).
Other projections raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["Warper", "make_warper", "backward_xy_1d", "result_roi",
           "u_period"]

_PROJECTIONS = ("spherical",)


def _spherical_fwd_np(x, y, z):
    """(azimuth u_, polar v_ = pi - acos(y / |r|))."""
    u_ = np.arctan2(x, z)
    r = np.sqrt(x * x + y * y + z * z)
    w = np.clip(y / np.maximum(r, 1e-30), -1.0, 1.0)
    return u_, np.pi - np.arccos(w)


def _forward_uv_np(points_xy, k, r, scale: float):
    """Pixel coords (..., 2) -> warped-plane coords, float32 numpy."""
    k = np.asarray(k, np.float32)
    r = np.asarray(r, np.float32)
    r_kinv = (r @ np.linalg.inv(k)).astype(np.float32)
    pts = np.asarray(points_xy, np.float32)
    p = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
    ray = p @ r_kinv.T
    u, v = _spherical_fwd_np(ray[..., 0], ray[..., 1], ray[..., 2])
    return u * np.float32(scale), v * np.float32(scale)


def backward_xy_1d(us: torch.Tensor, vs: torch.Tensor, k: torch.Tensor,
                   r: torch.Tensor, scale: float):
    """Source pixel coords (sx, sy) and validity (z > 0) over the grid
    us x vs, each (len(vs), len(us)); invalid rays map to -1."""
    k_rinv = k.to(torch.float32) @ r.to(torch.float32).t()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=us.device)
    u = us / scale
    v = vs / scale
    sinv = torch.sin(math.pi - v)[:, None]
    x_ = sinv * torch.sin(u)[None, :]
    y_ = torch.cos(math.pi - v)[:, None]
    z_ = sinv * torch.cos(u)[None, :]
    px = k_rinv[0, 0] * x_ + k_rinv[0, 1] * y_ + k_rinv[0, 2] * z_
    py = k_rinv[1, 0] * x_ + k_rinv[1, 1] * y_ + k_rinv[1, 2] * z_
    pz = k_rinv[2, 0] * x_ + k_rinv[2, 1] * y_ + k_rinv[2, 2] * z_
    valid = pz > 0
    zs = torch.where(torch.abs(pz) < 1e-12, 1e-12, pz)
    return (torch.where(valid, px / zs, -1.0),
            torch.where(valid, py / zs, -1.0), valid)


@dataclasses.dataclass(frozen=True)
class Warper:
    """Spherical rotation warper of a given scale
    (cv::detail::SphericalWarper)."""
    proj_name: str
    scale: float

    def detect_result_roi(self, src_hw: Tuple[int, int], k, r):
        """(tl_x, tl_y, br_x, br_y), br inclusive, from the source border
        mapped forward."""
        h, w = src_hw
        xs = np.arange(w, dtype=np.float32)
        ys = np.arange(h, dtype=np.float32)
        pts = np.concatenate([
            np.stack([xs, np.zeros_like(xs)], -1),
            np.stack([xs, np.full_like(xs, h - 1)], -1),
            np.stack([np.zeros_like(ys), ys], -1),
            np.stack([np.full_like(ys, w - 1), ys], -1),
        ])
        u, v = _forward_uv_np(pts, k, r, self.scale)
        # Date-line rebranch: a view straddling azimuth +-pi keeps the
        # tighter of the two branchings.
        period = 2.0 * math.pi * self.scale
        if float(u.max()) - float(u.min()) > 0.5 * period:
            cu, _ = _forward_uv_np(
                np.array([[(w - 1) / 2.0, (h - 1) / 2.0]], np.float32),
                k, r, self.scale)
            cu = float(cu[0])
            u2 = np.mod(u - cu + 0.5 * period, period) - 0.5 * period + cu
            if float(u2.max()) - float(u2.min()) <= 0.5 * period:
                u = u2
        tl_u, tl_v = float(u.min()), float(v.min())
        br_u, br_v = float(u.max()), float(v.max())
        # Pole fix: a pole inside the source extends the ROI to (0, 0).
        k_rinv = np.asarray(k, np.float64) @ np.asarray(r, np.float64).T
        for pole_y in (1.0, -1.0):
            p = k_rinv @ np.array([0.0, pole_y, 0.0])
            if p[2] > 0:
                x, y = p[0] / p[2], p[1] / p[2]
                if 0 < x < w and 0 < y < h:
                    tl_u, br_u = min(tl_u, 0.0), max(br_u, 0.0)
                    tl_v, br_v = min(tl_v, 0.0), max(br_v, 0.0)
        return (int(tl_u), int(tl_v), int(br_u), int(br_v))

    def warp_roi(self, src_hw: Tuple[int, int], k, r):
        """dst rect (x, y, width, height), cv::Rect semantics."""
        tlx, tly, brx, bry = self.detect_result_roi(src_hw, k, r)
        return (tlx, tly, brx - tlx + 1, bry - tly + 1)


def u_period(proj_name: str, scale: float):
    """Warped u-axis period in pixels for longitude-linear projections."""
    if proj_name in ("spherical", "cylindrical", "mercator"):
        return int(round(2.0 * math.pi * scale))
    return None


def make_warper(warp_type: str, scale: float) -> Warper:
    if warp_type not in _PROJECTIONS:
        raise NotImplementedError(
            f"warp_type={warp_type!r}: the PyTorch port implements only "
            "the spherical projection")
    return Warper(warp_type, float(scale))


def result_roi(corners, sizes) -> Tuple[int, int, int, int]:
    """cv::detail::resultRoi: union of per-image rects, (x, y, w, h)."""
    x = min(c[0] for c in corners)
    y = min(c[1] for c in corners)
    xe = max(c[0] + s[0] for c, s in zip(corners, sizes))
    ye = max(c[1] + s[1] for c, s in zip(corners, sizes))
    return (x, y, xe - x, ye - y)
