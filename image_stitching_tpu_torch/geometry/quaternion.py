"""Quaternion math on torch tensors (port of `geometry/quaternion.py`).

Quaternions are ``(..., 4)`` tensors laid out ``[x, y, z, w]``, the
reference's component order, and every operation is a batched function of
them.  The branchy steps (Shepperd's matrix-to-quaternion extraction,
slerp's small-angle fallback) compute every branch and select with
``torch.where``, as the reference does.  An Euler order is a string,
"XYZ" and so on, one to one with the reference's `EulerOrder` (an enum
member is taken through its `.value`).  No stitch path calls these.
"""

from __future__ import annotations

import torch

from .euler import _order

__all__ = [
    "identity",
    "from_euler",
    "from_axis_angle",
    "from_rotation_matrix",
    "from_unit_vectors",
    "to_rotation_matrix",
    "multiply",
    "conjugate",
    "invert",
    "dot",
    "norm",
    "normalize",
    "angle_to",
    "rotate_towards",
    "slerp",
    "apply_to_vector",
]


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


def identity(dtype=torch.float32) -> torch.Tensor:
    """The identity quaternion [0, 0, 0, 1]."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)


# Per order, the signs of the second term of qx, qy, qz, qw: each component
# is c1 c2 c3 / s1 s2 s3 products plus or minus the mixed one.
_EULER_SIGNS = {
    "XYZ": (1, -1, 1, -1),
    "YXZ": (1, -1, -1, 1),
    "ZXY": (-1, 1, 1, -1),
    "ZYX": (-1, 1, -1, 1),
    "YZX": (1, 1, -1, -1),
    "XZY": (-1, -1, 1, 1),
}


def from_euler(euler, order) -> torch.Tensor:
    """Quaternion from intrinsic Euler angles ``(..., 3)`` = [x, y, z]
    radians; the order names the axis rotations composed left to right
    ("XYZ": q = qx * qy * qz)."""
    euler = _t(euler)
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    c1, s1 = torch.cos(x * 0.5), torch.sin(x * 0.5)
    c2, s2 = torch.cos(y * 0.5), torch.sin(y * 0.5)
    c3, s3 = torch.cos(z * 0.5), torch.sin(z * 0.5)
    sx, sy, sz, sw = _EULER_SIGNS[_order(order)]
    qx = s1 * c2 * c3 + sx * (c1 * s2 * s3)
    qy = c1 * s2 * c3 + sy * (s1 * c2 * s3)
    qz = c1 * c2 * s3 + sz * (s1 * s2 * c3)
    qw = c1 * c2 * c3 + sw * (s1 * s2 * s3)
    return torch.stack([qx, qy, qz, qw], dim=-1)


def from_axis_angle(axis, angle) -> torch.Tensor:
    """Quaternion from a (unit) axis ``(..., 3)`` and an angle ``(...)``."""
    axis, angle = _t(axis), _t(angle)
    half = angle * 0.5
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def from_rotation_matrix(m) -> torch.Tensor:
    """Quaternion from a ``(..., 3, 3)`` rotation matrix by Shepperd's
    method: all four branches computed, the one the trace and diagonal
    pick selected."""
    m = _t(m)
    m11, m12, m13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m21, m22, m23 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m31, m32, m33 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    trace = m11 + m22 + m33

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-30))

    s0 = 0.5 / safe_sqrt(trace + 1.0)
    q0 = torch.stack([(m32 - m23) * s0, (m13 - m31) * s0, (m21 - m12) * s0,
                      0.25 / s0], dim=-1)
    s1 = 2.0 * safe_sqrt(1.0 + m11 - m22 - m33)
    q1 = torch.stack([0.25 * s1, (m12 + m21) / s1, (m13 + m31) / s1,
                      (m32 - m23) / s1], dim=-1)
    s2 = 2.0 * safe_sqrt(1.0 + m22 - m11 - m33)
    q2 = torch.stack([(m12 + m21) / s2, 0.25 * s2, (m23 + m32) / s2,
                      (m13 - m31) / s2], dim=-1)
    s3 = 2.0 * safe_sqrt(1.0 + m33 - m11 - m22)
    q3 = torch.stack([(m13 + m31) / s3, (m23 + m32) / s3, 0.25 * s3,
                      (m21 - m12) / s3], dim=-1)
    use0 = (trace > 0.0)[..., None]
    use1 = ((m11 > m22) & (m11 > m33))[..., None]
    use2 = (m22 > m33)[..., None]
    return torch.where(use0, q0, torch.where(use1, q1,
                                             torch.where(use2, q2, q3)))


def from_unit_vectors(v_from, v_to) -> torch.Tensor:
    """Shortest-arc quaternion turning unit vector v_from onto v_to; for
    antiparallel vectors, half a turn about an axis orthogonal to
    v_from."""
    v_from, v_to = _t(v_from), _t(v_to)
    r = torch.sum(v_from * v_to, dim=-1) + 1.0
    q_reg = torch.cat([torch.linalg.cross(v_from, v_to), r[..., None]],
                      dim=-1)
    fx, fy, fz = v_from[..., 0], v_from[..., 1], v_from[..., 2]
    zero = torch.zeros_like(fx)
    use_x = torch.abs(fx) > torch.abs(fz)
    q_anti = torch.stack([torch.where(use_x, -fy, zero),
                          torch.where(use_x, fx, -fz),
                          torch.where(use_x, zero, fy), zero], dim=-1)
    return normalize(torch.where((r < 1e-8)[..., None], q_anti, q_reg))


def to_rotation_matrix(q) -> torch.Tensor:
    """``(..., 4)`` quaternion -> ``(..., 3, 3)`` rotation matrix."""
    q = _t(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    row0 = torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1)
    row1 = torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1)
    row2 = torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def multiply(a, b) -> torch.Tensor:
    """Hamilton product a * b (b's rotation, then a's)."""
    a, b = _t(a), _t(b)
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([ax * bw + aw * bx + ay * bz - az * by,
                        ay * bw + aw * by + az * bx - ax * bz,
                        az * bw + aw * bz + ax * by - ay * bx,
                        aw * bw - ax * bx - ay * by - az * bz], dim=-1)


def conjugate(q) -> torch.Tensor:
    """The vector part negated."""
    q = _t(q)
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def invert(q) -> torch.Tensor:
    """The inverse; the conjugate for unit quaternions."""
    q = _t(q)
    return conjugate(q) / torch.clamp(torch.sum(q * q, dim=-1, keepdim=True),
                                      min=1e-30)


def dot(a, b) -> torch.Tensor:
    """The 4-component dot product."""
    return torch.sum(_t(a) * _t(b), dim=-1)


def norm(q) -> torch.Tensor:
    q = _t(q)
    return torch.sqrt(torch.sum(q * q, dim=-1))


def normalize(q) -> torch.Tensor:
    """Unit length; a zero quaternion becomes the identity."""
    q = _t(q)
    n = norm(q)[..., None]
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=q.dtype,
                         device=q.device).expand(q.shape)
    return torch.where(n > 1e-30, q / torch.clamp(n, min=1e-30), ident)


def angle_to(a, b) -> torch.Tensor:
    """The angle between two rotations."""
    return 2.0 * torch.arccos(torch.clamp(torch.abs(dot(a, b)), -1.0, 1.0))


def rotate_towards(a, b, step) -> torch.Tensor:
    """a turned towards b by at most `step` radians."""
    angle = angle_to(a, b)
    step = _t(step)
    t = torch.where(angle == 0.0, torch.ones_like(angle),
                    torch.clamp(step / torch.clamp(angle, min=1e-30),
                                max=1.0))
    return slerp(a, b, t)


def slerp(a, b, t) -> torch.Tensor:
    """Spherical linear interpolation along the shorter arc, normalised
    lerp where a and b are nearly parallel."""
    a, b = _t(a), _t(b)
    t = _t(t)[..., None]
    cos_half = dot(a, b)[..., None]
    b = b * torch.where(cos_half < 0.0, -1.0, 1.0)
    cos_half = torch.clamp(torch.abs(cos_half), -1.0, 1.0)
    sin_half_sq = 1.0 - cos_half * cos_half
    half = torch.arccos(cos_half)
    sin_half = torch.sqrt(torch.clamp(sin_half_sq, min=1e-30))
    q_slerp = (a * (torch.sin((1.0 - t) * half) / sin_half)
               + b * (torch.sin(t * half) / sin_half))
    q_lerp = normalize(a * (1.0 - t) + b * t)
    return torch.where(sin_half_sq <= 1e-12, q_lerp, q_slerp)


def apply_to_vector(q, v) -> torch.Tensor:
    """Vector(s) v rotated by q (q v q^-1)."""
    q, v = _t(q), _t(v)
    qvec, w = q[..., :3], q[..., 3:4]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (w * uv + uuv)
