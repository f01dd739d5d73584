"""Euler angles -> rotation matrix in numpy (port of `geometry/euler.py:60`).

The order string names the intrinsic sequence composed left to right:
``"YXZ"`` gives ``Ry(y) @ Rx(x) @ Rz(z)``.  Host-side, for the synthetic
captures.
"""

from __future__ import annotations

import numpy as np

__all__ = ["euler_to_rotation_matrix"]


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
    order = getattr(order, "value", order).upper()
    idx = {"X": 0, "Y": 1, "Z": 2}
    m = [_rot(a, euler[..., idx[a]]) for a in order]
    return m[0] @ m[1] @ m[2]
