"""Rodrigues vectors <-> rotation matrices on torch tensors.

Port of `image_stitching_tpu/geometry/rotation.py:32-110`.  The Rodrigues
maps are branchless (torch.where), so forward-mode `torch.func.jvp`
differentiates `rodrigues_to_matrix` inside the bundle adjuster.
`orthonormalize` projects a near-rotation onto SO(3); `rad_to_deg` and
`deg_to_rad` convert angles.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rodrigues_to_matrix", "matrix_to_rodrigues", "rad_to_deg",
           "deg_to_rad", "orthonormalize"]


def rad_to_deg(rad):
    """Radians to degrees (`image_stitching.cpp:126-130`)."""
    return rad / math.pi * 180.0


def deg_to_rad(deg):
    """Degrees to radians (`image_stitching.cpp:132-136`)."""
    return deg / 180.0 * math.pi


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), Taylor-safe
    near theta = 0."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = torch.zeros_like(x)
    k = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def matrix_to_rodrigues(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), handling the
    theta ~ 0 and theta ~ pi regimes branchlessly."""
    trace = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    ax = m[..., 2, 1] - m[..., 1, 2]
    ay = m[..., 0, 2] - m[..., 2, 0]
    az = m[..., 1, 0] - m[..., 0, 1]
    axis_sin = torch.stack([ax, ay, az], dim=-1) * 0.5
    sin_t = torch.sqrt(torch.sum(axis_sin * axis_sin, dim=-1))
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(
        sin_t[..., None] > 1e-6,
        theta[..., None] / torch.clamp(sin_t[..., None], min=1e-30),
        1.0 + theta[..., None] ** 2 / 6.0)
    r_generic = axis_sin * scale

    diag = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_t[..., None]) /
                          torch.clamp(1.0 - cos_t[..., None], min=1e-30),
                          min=0.0)
    axis_abs = torch.sqrt(axis_sq)
    one = torch.ones_like(axis_abs[..., 0])
    sy = torch.where(m[..., 0, 1] + m[..., 1, 0] < 0, -one, one)
    sz = torch.where(m[..., 0, 2] + m[..., 2, 0] < 0, -one, one)
    sz = torch.where(axis_abs[..., 0] < 1e-3,
                     torch.where(m[..., 1, 2] + m[..., 2, 1] < 0, -one, one)
                     * sy, sz)
    sign_prod = torch.stack([one, sy, sz], dim=-1)
    sign_asin = torch.where(axis_sin >= 0, 1.0, -1.0).to(m.dtype)
    sign = torch.where(torch.abs(axis_sin) > 1e-5, sign_asin, sign_prod)
    r_pi = axis_abs * sign * theta[..., None]
    return torch.where((cos_t < -0.9)[..., None], r_pi, r_generic)


def orthonormalize(m: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) near-rotations onto SO(3) by SVD, det +1
    enforced on the last singular direction."""
    u, _, vt = torch.linalg.svd(m)
    fix = torch.ones(m.shape[:-2] + (3,), dtype=m.dtype, device=m.device)
    fix[..., 2] = torch.linalg.det(u @ vt)
    return (u * fix[..., None, :]) @ vt
