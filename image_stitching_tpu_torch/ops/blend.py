"""Blenders NO / FEATHER / MULTI_BAND of the loop compose (port of
`ops/blend.py`).

cv::detail::Blender semantics with canvas accumulators on the device:
`make_blender` takes the band count from the canvas area and the blend
strength (NO when the blend width is under 1).  `MultiBandBlender.feed`
expands each image's rect by 3 * 2^bands, snaps it to the band grid,
pads the image by BORDER_REFLECT_101 (repeated when the gap exceeds the
image, as numpy pads) and its weight by zeros, and hands kernel K5
(`kernels/multiband.py::pyramid_accumulate`) a bucket of that one rect:
its Laplacian pyramid, weighted by the weight's Gaussian pyramid, is
added into the (4, Hb, Wb) band accumulators.  `blend` normalises each
band by its weight and collapses the pyramid, in float (the fused
compose rounds to u8; the loop does not).  FeatherBlender weighs each
pixel by its clipped distance to the nearest unset mask pixel (the native
EDT, as the voronoi seam finder takes it); NoBlender overwrites.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import BlenderType
from ..kernels.multiband import pyramid_accumulate
from .pyr_mat import pyr_down_mm, pyr_up_mm
from .seams import edt_sq
from .warps import result_roi

__all__ = ["WEIGHT_EPS", "num_bands_for", "pyr_down", "pyr_up",
           "collapse", "make_blender", "MultiBandBlender", "FeatherBlender",
           "NoBlender"]

WEIGHT_EPS = 1e-5


def num_bands_for(canvas_roi, blend_strength: float) -> Tuple[int, float]:
    """(num_bands, blend_width) of cv MultiBandBlender for a canvas ROI."""
    area = canvas_roi[2] * canvas_roi[3]
    blend_width = float(np.sqrt(area) * blend_strength / 100.0)
    if blend_width < 1.0:
        return 0, blend_width
    return max(int(np.ceil(np.log2(blend_width)) - 1.0), 0), blend_width


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown of an (H, W) or (H, W, C) image."""
    if x.ndim == 2:
        return pyr_down_mm(x)
    return pyr_down_mm(x.permute(2, 0, 1)).permute(1, 2, 0)


def pyr_up(x: torch.Tensor, out_hw) -> torch.Tensor:
    """cv::pyrUp of an (h, w) or (h, w, C) image to out_hw."""
    if x.ndim == 2:
        return pyr_up_mm(x, out_hw)
    return pyr_up_mm(x.permute(2, 0, 1), out_hw).permute(1, 2, 0)


def collapse(accs: List[torch.Tensor], n_bands: int):
    """Normalise each (4, Hb, Wb) band accumulator by its weight (channel
    3) and collapse the pyramid: (planar float32 (3, H, W), mask (H, W)).
    Each band is normalised as the collapse reaches it, so one normalised
    band is held at a time."""
    def band(b):
        return accs[b][:3] / (accs[b][3:4] + WEIGHT_EPS)
    out = band(n_bands)
    for b in range(n_bands - 1, -1, -1):
        out = pyr_up_mm(out, accs[b].shape[1:])
        out += band(b)
    return out, accs[0][3] > WEIGHT_EPS


def _reflect101(lo: int, hi: int, n: int, device) -> torch.Tensor:
    """Source indices lo .. hi - 1 of an axis of n, folded by
    BORDER_REFLECT_101 with period 2 (n - 1): numpy's reflect pad, which
    reflects again where the pad exceeds the axis."""
    i = np.arange(lo, hi)
    if n == 1:
        return torch.zeros(len(i), dtype=torch.int64, device=device)
    i = np.mod(i, 2 * (n - 1))
    return torch.as_tensor(np.where(i < n, i, 2 * (n - 1) - i),
                           device=device)


class MultiBandBlender:
    """cv::detail::MultiBandBlender with device band accumulators, fed
    through K5."""

    def __init__(self, corners, sizes, num_bands: int, device="cuda"):
        x, y, w, h = result_roi(corners, sizes)
        self.final_roi = (x, y, w, h)
        step = 1 << num_bands
        wpad = -(-w // step) * step
        hpad = -(-h // step) * step
        self.roi = (x, y, wpad, hpad)
        self.num_bands = num_bands
        self.accs = [torch.zeros((4, hpad >> b, wpad >> b),
                                 dtype=torch.float32, device=device)
                     for b in range(num_bands + 1)]

    def rect(self, corner, h: int, w: int) -> Tuple[int, int, int, int]:
        """The band-aligned canvas rect (tlx, tly, brx, bry) that an
        (h, w) image at `corner` feeds: its rect grown by the gap
        3 * 2^bands, cut to the canvas, snapped to the band grid."""
        gap = 3 * (1 << self.num_bands)
        step = 1 << self.num_bands
        rx, ry, rw, rh = self.roi
        tlx = max(rx, corner[0] - gap)
        tly = max(ry, corner[1] - gap)
        brx = min(rx + rw, corner[0] + w + gap)
        bry = min(ry + rh, corner[1] + h + gap)
        tlx = rx + (((tlx - rx) >> self.num_bands) << self.num_bands)
        tly = ry + (((tly - ry) >> self.num_bands) << self.num_bands)
        brx = rx + min(-(-(brx - rx) // step) * step, rw)
        bry = ry + min(-(-(bry - ry) // step) * step, rh)
        return tlx, tly, brx, bry

    def feed(self, img: torch.Tensor, mask: torch.Tensor, corner) -> None:
        """Accumulate the (h, w, 3) image under the (h, w) mask at corner:
        one K5 call on a bucket of one padded rect."""
        h, w = img.shape[0], img.shape[1]
        tlx, tly, brx, bry = self.rect(corner, h, w)
        dev = img.device
        rows = _reflect101(tly - corner[1], bry - corner[1], h, dev)
        cols = _reflect101(tlx - corner[0], brx - corner[0], w, dev)
        planar = img.to(torch.float32).permute(2, 0, 1)
        warped = planar[:, rows][:, :, cols]
        weight = torch.zeros((bry - tly, brx - tlx), dtype=torch.float32,
                             device=dev)
        top, left = corner[1] - tly, corner[0] - tlx
        weight[top:top + h, left:left + w] = (mask > 0).to(torch.float32)
        rx, ry = self.roi[0], self.roi[1]
        pyramid_accumulate(warped[None].contiguous(), weight[None],
                           [(tlx - rx, tly - ry)], self.accs,
                           self.num_bands)

    def blend(self):
        """(panorama float32 (H, W, 3), mask bool (H, W)) of the final
        ROI."""
        out, mask = collapse(self.accs, self.num_bands)
        fw, fh = self.final_roi[2], self.final_roi[3]
        return out.permute(1, 2, 0)[:fh, :fw], mask[:fh, :fw]


class FeatherBlender:
    """cv::detail::FeatherBlender: each pixel weighs min(d * sharpness,
    1), d its Euclidean distance to the nearest unset mask pixel."""

    def __init__(self, corners, sizes, sharpness: float, device="cuda"):
        x, y, w, h = result_roi(corners, sizes)
        self.roi = (x, y, w, h)
        self.sharpness = sharpness
        self.acc = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
        self.wacc = torch.zeros((h, w), dtype=torch.float32, device=device)

    def feed(self, img: torch.Tensor, mask: torch.Tensor, corner) -> None:
        m = mask > 0
        dist = torch.sqrt(torch.as_tensor(
            edt_sq(m.cpu().numpy()), dtype=torch.float32, device=img.device))
        weight = torch.clamp(dist * self.sharpness, 0.0, 1.0) * m
        x, y = corner[0] - self.roi[0], corner[1] - self.roi[1]
        h, w = img.shape[0], img.shape[1]
        self.acc[y:y + h, x:x + w] += img.to(torch.float32) * weight[..., None]
        self.wacc[y:y + h, x:x + w] += weight

    def blend(self):
        out = self.acc / (self.wacc[..., None] + WEIGHT_EPS)
        return out, self.wacc > WEIGHT_EPS


class NoBlender:
    """Blender::NO: a plain overwrite where the mask is set."""

    def __init__(self, corners, sizes, device="cuda"):
        x, y, w, h = result_roi(corners, sizes)
        self.roi = (x, y, w, h)
        self.canvas = torch.zeros((h, w, 3), dtype=torch.float32,
                                  device=device)
        self.mask = torch.zeros((h, w), dtype=torch.bool, device=device)

    def feed(self, img: torch.Tensor, mask: torch.Tensor, corner) -> None:
        m = mask > 0
        x, y = corner[0] - self.roi[0], corner[1] - self.roi[1]
        h, w = img.shape[0], img.shape[1]
        cur = self.canvas[y:y + h, x:x + w]
        self.canvas[y:y + h, x:x + w] = torch.where(
            m[..., None], img.to(torch.float32), cur)
        self.mask[y:y + h, x:x + w] |= m

    def blend(self):
        return self.canvas, self.mask


def make_blender(corners, sizes, blend_type: BlenderType,
                 blend_strength: float = 5.0, device="cuda"):
    """The blender for the compose ROIs, with the reference's fallback to
    NO when the blend width is under 1."""
    roi = result_roi(corners, sizes)
    n_bands, blend_width = num_bands_for(roi, blend_strength)
    if blend_width < 1.0 or blend_type == BlenderType.NO:
        return NoBlender(corners, sizes, device)
    if blend_type == BlenderType.MULTI_BAND:
        return MultiBandBlender(corners, sizes, n_bands, device)
    return FeatherBlender(corners, sizes, 1.0 / blend_width, device)
