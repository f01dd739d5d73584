"""cv2 pyrDown/pyrUp as dense banded matrix products (port of the dense
part of `ops/pyr_mat.py`).

pyrDown(x) = D_h @ x @ D_w^T and pyrUp(x) = U_h @ x @ U_w^T: a separable
5-tap [1, 4, 6, 4, 1] / 16 blur with BORDER_REFLECT_101 folded together
with the 2x decimation or zero-stuffing.  Each output is a <= 5-term sum.
The reference switches to tiled einsums above a 4096-px axis for the
TPU's compile limits; the dense matrices serve every size here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["down_mats", "up_mats", "pyr_down_mm", "pyr_up_mm"]

_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0


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


def down_mats(h: int, w: int, device="cpu"):
    """(D_h (ceil(h/2), h), D_w (ceil(w/2), w))."""
    dev = str(device)
    return _on_device("down", (h,), dev), _on_device("down", (w,), dev)


def up_mats(out_h: int, out_w: int, in_h: int, in_w: int, device="cpu"):
    """(U_h (out_h, in_h), U_w (out_w, in_w))."""
    dev = str(device)
    return (_on_device("up", (out_h, in_h), dev),
            _on_device("up", (out_w, in_w), dev))


def pyr_down_mm(x: torch.Tensor) -> torch.Tensor:
    """cv2 pyrDown on (..., H, W)."""
    dh, dw = down_mats(x.shape[-2], x.shape[-1], x.device)
    return dh @ x @ dw.t()


def pyr_up_mm(x: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2 pyrUp on (..., h, w) -> (..., out_h, out_w)."""
    uh, uw = up_mats(out_hw[0], out_hw[1], x.shape[-2], x.shape[-1],
                     x.device)
    return uh @ x @ uw.t()
