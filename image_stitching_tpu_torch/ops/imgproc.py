"""Image-processing primitives on torch tensors (port of `ops/imgproc.py`).

Each function keeps the reference's arithmetic in the same order, so CPU
results agree with the JAX package to float32 rounding.  Images are HWC or
HW; `resize` works on the two leading axes like the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["scale_size", "resize", "resize_scale", "rgb_to_gray",
           "gaussian_blur", "gaussian_kernel1d", "box_blur", "dilate3",
           "reflect101_index", "fma"]


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, like the fused multiply-add that
    XLA contracts such expressions into on CPU and TPU.  The float64
    product is exact, so this matches a true FMA except where the float64
    sum lands on a float32 rounding midpoint."""
    return (a.double() * torch.as_tensor(b).double() +
            torch.as_tensor(c).double()).to(torch.float32)


def scale_size(h: int, w: int, scale: float) -> Tuple[int, int]:
    """cv::resize(Size(), fx, fy) rounding: round(dim * scale)."""
    return max(1, int(round(h * scale))), max(1, int(round(w * scale)))


def resize(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (INTER_LINEAR_EXACT:
    src = (dst + 0.5) * scale - 0.5, edge-clamped); float32 out.  The
    coordinate and interpolation steps round like the reference's fused
    multiply-adds (`fma`), which keeps CPU results bit-equal to it."""
    h, w = img.shape[0], img.shape[1]
    oh, ow = out_hw
    x = img.to(torch.float32)
    if (oh, ow) == (h, w):
        return x
    dev = x.device
    sy, sx = h / oh, w / ow
    ys = fma(torch.arange(oh, dtype=torch.float32, device=dev) + 0.5,
             torch.tensor(sy, dtype=torch.float32, device=dev), -0.5)
    xs = fma(torch.arange(ow, dtype=torch.float32, device=dev) + 0.5,
             torch.tensor(sx, dtype=torch.float32, device=dev), -0.5)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    row0 = x[y0i]
    row1 = x[y1i]
    rows = fma(row1 - row0, wy.reshape(-1, *([1] * (x.ndim - 1))), row0)
    c0 = rows[:, x0i]
    c1 = rows[:, x1i]
    return fma(c1 - c0, wx.reshape((1, -1) + (1,) * (x.ndim - 2)), c0)


def resize_scale(img: torch.Tensor, scale: float) -> torch.Tensor:
    """`resize` to the dims cv::resize gives `scale`."""
    return resize(img, scale_size(img.shape[0], img.shape[1], scale))


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (cv COLOR_RGB2GRAY coefficients), rounded like
    the reference's contraction: fma(.114, b, fma(.299, r, .587 g))."""
    img = img.to(torch.float32)
    return fma(img[..., 2], 0.114,
               fma(img[..., 0], 0.299, 0.587 * img[..., 1]))


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of an axis padded by `pad` on both sides with
    BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba); valid for pad < n."""
    i = np.arange(-pad, n + pad)
    i = np.abs(i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return torch.as_tensor(i, device=device)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur, reflect-101 borders (rows, then columns).
    Taps are summed in the reference's order and rounding:
    fma(k0, x0, k1 x1), then fma(k_i, x_i, acc)."""
    k = [float(v) for v in gaussian_kernel1d(sigma, radius)]
    x = img.to(torch.float32)
    h, w = x.shape[0], x.shape[1]

    def taps(get):
        acc = fma(get(0), k[0], k[1] * get(1))
        for i in range(2, 2 * radius + 1):
            acc = fma(get(i), k[i], acc)
        return acc
    xp = x[reflect101_index(h, radius, x.device)]
    acc = taps(lambda i: xp[i:i + h])
    xp = acc[:, reflect101_index(w, radius, x.device)]
    return taps(lambda i: xp[:, i:i + w])


def box_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size box filter with reflect-101 borders, HW or HWC: the
    window summed row-major from 0, as the reference's reduce_window,
    then divided by size^2."""
    x = img.to(torch.float32)
    h, w = x.shape[0], x.shape[1]
    r = size // 2
    xp = x[reflect101_index(h, r, x.device)][:, reflect101_index(
        w, r, x.device)]
    acc = torch.zeros_like(x)
    for dy in range(size):
        for dx in range(size):
            acc = acc + xp[dy:dy + h, dx:dx + w]
    return acc / (size * size)


def dilate3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 max with -inf padding (cv::dilate, default kernel) on (..., H, W)
    float masks."""
    shape = mask.shape
    m = mask.to(torch.float32).reshape(-1, 1, shape[-2], shape[-1])
    out = F.max_pool2d(m, 3, stride=1, padding=1)
    return out.reshape(shape).to(mask.dtype)
