"""Euler angles <-> rotation matrices in numpy (port of
`geometry/euler.py:60` and `:73`).

An order is a string naming the intrinsic sequence composed left to right,
``"YXZ"`` giving ``Ry(y) @ Rx(x) @ Rz(z)``; the six strings are the values
of the reference's `EulerOrder` enum one to one (an enum member is taken
through its `.value`).  Angles are (..., 3) arrays [x, y, z] in radians.
Host-side: the synthetic captures and the pose infill.
"""

from __future__ import annotations

import numpy as np

__all__ = ["euler_to_rotation_matrix", "rotation_matrix_to_euler",
           "ORDERS"]

ORDERS = ("XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX")
_GIMBAL_EPS = 0.9999999


def _order(order) -> str:
    order = getattr(order, "value", order).upper()
    if order not in ORDERS:
        raise ValueError(f"unknown euler order {order}")
    return order


def _rot(axis: str, a):
    c, s = np.cos(a), np.sin(a)
    one, zero = np.ones_like(a), np.zeros_like(a)
    if axis == "X":
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == "Y":
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def euler_to_rotation_matrix(euler, order: str = "YXZ") -> np.ndarray:
    """(..., 3) angles [x, y, z] in radians -> (..., 3, 3)."""
    euler = np.asarray(euler)
    idx = {"X": 0, "Y": 1, "Z": 2}
    m = [_rot(a, euler[..., idx[a]]) for a in _order(order)]
    return m[0] @ m[1] @ m[2]


def rotation_matrix_to_euler(m, order: str = "YXZ") -> np.ndarray:
    """(..., 3, 3) -> (..., 3) angles [x, y, z]; where |sin| of the middle
    angle reaches 0.9999999 (gimbal lock) one angle collapses to 0, as in
    the reference."""
    m = np.asarray(m)
    m11, m12, m13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m21, m22, m23 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m31, m32, m33 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    zero = np.zeros_like(m11)

    def clamp(v):
        return np.clip(v, -1.0, 1.0)
    order = _order(order)
    if order == "XYZ":
        y = np.arcsin(clamp(m13))
        ok = np.abs(m13) < _GIMBAL_EPS
        x = np.where(ok, np.arctan2(-m23, m33), np.arctan2(m32, m22))
        z = np.where(ok, np.arctan2(-m12, m11), zero)
    elif order == "YXZ":
        x = np.arcsin(-clamp(m23))
        ok = np.abs(m23) < _GIMBAL_EPS
        y = np.where(ok, np.arctan2(m13, m33), np.arctan2(-m31, m11))
        z = np.where(ok, np.arctan2(m21, m22), zero)
    elif order == "ZXY":
        x = np.arcsin(clamp(m32))
        ok = np.abs(m32) < _GIMBAL_EPS
        y = np.where(ok, np.arctan2(-m31, m33), zero)
        z = np.where(ok, np.arctan2(-m12, m22), np.arctan2(m21, m11))
    elif order == "ZYX":
        y = np.arcsin(-clamp(m31))
        ok = np.abs(m31) < _GIMBAL_EPS
        x = np.where(ok, np.arctan2(m32, m33), zero)
        z = np.where(ok, np.arctan2(m21, m11), np.arctan2(-m12, m22))
    elif order == "YZX":
        z = np.arcsin(clamp(m21))
        ok = np.abs(m21) < _GIMBAL_EPS
        x = np.where(ok, np.arctan2(-m23, m22), zero)
        y = np.where(ok, np.arctan2(-m31, m11), np.arctan2(m13, m33))
    else:  # XZY
        z = np.arcsin(-clamp(m12))
        ok = np.abs(m12) < _GIMBAL_EPS
        x = np.where(ok, np.arctan2(m32, m22), np.arctan2(-m23, m33))
        y = np.where(ok, np.arctan2(m13, m11), zero)
    return np.stack([x, y, z], axis=-1)
