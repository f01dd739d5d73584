"""cv2 pyrDown/pyrUp as banded matrix products (port of `ops/pyr_mat.py`).

pyrDown(x) = D_h @ x @ D_w^T and pyrUp(x) = U_h @ x @ U_w^T: a separable
5-tap [1, 4, 6, 4, 1] / 16 blur with BORDER_REFLECT_101 folded together
with the 2x decimation or zero-stuffing.  Each output is a <= 5-term sum.
Up to a 4096-px axis (`_T_DENSE`, the reference's threshold) an axis is a
product with its dense matrix; above it, the same sums are taken as five
shifted slices of the reflect-padded axis (pyrUp folds the zero-stuffing
parity into two 3- and 2-tap stencils), so no (n x n) matrix is built for
a wide canvas.  The reference tiles einsums there for the TPU's compile
limits; the stencil is the same arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["down_mats", "up_mats", "pyr_down_mm", "pyr_up_mm"]

_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0
_T_DENSE = 4096


def _reflect101(i: int, n: int) -> int:
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i = i % period
    return i if i < n else period - i


@functools.lru_cache(maxsize=64)
def _down_mat_np(n: int) -> np.ndarray:
    """((n+1)//2, n): 5-tap blur rows at even positions."""
    m = np.zeros(((n + 1) // 2, n), np.float64)
    for o in range((n + 1) // 2):
        for j in range(5):
            m[o, _reflect101(2 * o + j - 2, n)] += _K5[j]
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _up_mat_np(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in): zero-stuff, 5-tap blur, x2 per axis."""
    m = np.zeros((n_out, n_in), np.float64)
    for o in range(n_out):
        for j in range(5):
            t = _reflect101(o + j - 2, n_out)
            if t % 2 == 0 and t // 2 < n_in:
                m[o, t // 2] += 2.0 * _K5[j]
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(kind: str, shape: tuple, device: str) -> torch.Tensor:
    """Device copy of one matrix, cached so each shape uploads once."""
    m = _down_mat_np(*shape) if kind == "down" else _up_mat_np(*shape)
    return torch.as_tensor(m, device=device)


def down_mats(h: int, w: int, device="cuda"):
    """(D_h (ceil(h/2), h), D_w (ceil(w/2), w))."""
    dev = str(device)
    return _on_device("down", (h,), dev), _on_device("down", (w,), dev)


def up_mats(out_h: int, out_w: int, in_h: int, in_w: int, device="cuda"):
    """(U_h (out_h, in_h), U_w (out_w, in_w))."""
    dev = str(device)
    return (_on_device("up", (out_h, in_h), dev),
            _on_device("up", (out_w, in_w), dev))


def _take(x: torch.Tensor, axis: int, idx) -> torch.Tensor:
    return torch.index_select(x, axis, torch.as_tensor(
        np.asarray(idx, np.int64), device=x.device))


def _strided(x: torch.Tensor, axis: int, start: int, count: int,
             step: int) -> torch.Tensor:
    return x.narrow(axis, start, step * (count - 1) + 1)[
        (slice(None),) * (x.ndim + axis) + (slice(None, None, step),)]


def _down_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """pyrDown along `axis` (-1 or -2)."""
    n = x.shape[axis]
    n_half = (n + 1) // 2
    if n <= _T_DENSE:
        m = _on_device("down", (n,), str(x.device))
        return x @ m.t() if axis == -1 else m @ x
    # xp[k] = x[reflect101(k - 2)]; output o = sum_j K5[j] xp[2o + j],
    # accumulated in place.
    xp = _take(x, axis, [_reflect101(k - 2, n) for k in range(n + 4)])
    out = torch.mul(_strided(xp, axis, 0, n_half, 2), float(_K5[0]))
    for j in range(1, 5):
        out.add_(_strided(xp, axis, j, n_half, 2), alpha=float(_K5[j]))
    return out


def _up_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """pyrUp along `axis` (-1 or -2) to n_out in {2 n_in, 2 n_in - 1}."""
    n_in = x.shape[axis]
    if n_out <= _T_DENSE:
        m = _on_device("up", (n_out, n_in), str(x.device))
        return x @ m.t() if axis == -1 else m @ x
    if n_out not in (2 * n_in, 2 * n_in - 1):
        raise ValueError(f"pyr_up_mm: {n_in} -> {n_out} is not a pyrUp")
    # xe[k] is the stuffed axis at 2 (k - 1), folded by REFLECT_101 on
    # n_out: its left edge is x[1], its right x[-1] (even n_out) or x[-2].
    right = n_in - 1 if n_out % 2 == 0 else n_in - 2
    xe = _take(x, axis, [1] + list(range(n_in)) + [right])
    n_even, n_odd = (n_out + 1) // 2, n_out // 2
    shape = list(x.shape)
    shape[axis] = n_out
    out = x.new_empty(shape)
    lead = (slice(None),) * (x.ndim + axis)
    # Even outputs [2, 12, 2] / 16 over xe[m .. m + 2], odd ones [8, 8] / 16
    # over xe[m + 1 .. m + 2], written into their strided halves of out.
    even = out[lead + (slice(0, None, 2),)]
    torch.mul(_strided(xe, axis, 0, n_even, 1), 0.125, out=even)
    even.add_(_strided(xe, axis, 1, n_even, 1), alpha=0.75)
    even.add_(_strided(xe, axis, 2, n_even, 1), alpha=0.125)
    odd = out[lead + (slice(1, None, 2),)]
    torch.mul(_strided(xe, axis, 1, n_odd, 1), 0.5, out=odd)
    odd.add_(_strided(xe, axis, 2, n_odd, 1), alpha=0.5)
    return out


def pyr_down_mm(x: torch.Tensor) -> torch.Tensor:
    """cv2 pyrDown on (..., H, W): rows, then columns (D_h @ x @ D_w^T in
    the dense matrices' order)."""
    return _down_axis(_down_axis(x, -2), -1)


def pyr_up_mm(x: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2 pyrUp on (..., h, w) -> (..., out_h, out_w): rows, then
    columns (U_h @ x @ U_w^T in the dense matrices' order)."""
    return _up_axis(_up_axis(x, out_hw[0], -2), out_hw[1], -1)
