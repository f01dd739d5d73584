"""AKAZE-family detector/descriptor (port of
`image_stitching_tpu/ops/features/akaze.py`).

The scale space evolves by explicit Perona-Malik diffusion steps
(`hessian.diffusion_step`) instead of Gaussian blurring; keypoints rank by
the determinant of the Hessian across the evolution.  The orientation is
the summed gradient over a radius-6 disk of the second layer, and the
descriptor is M-LDB-style: the means of the intensity, dx and dy over a
rotated 4x4 grid of 7x7 cells, all C(16, 2) comparisons per channel: 360
bits in 12 int32 words (bit b of word w at 32 w + b), Hamming-matched like
ORB's by kernel K4.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..imgproc import fma, gaussian_blur
from .hessian import central_grad, det_hessian, diffusion_step, top_k_keypoints
from .surf import disk_orientation
from .types import Features

__all__ = ["akaze_detect_and_describe", "akaze_with_means", "pack_bits",
           "bit_pairs"]

_N_LAYERS = 4
_STEPS_PER_LAYER = 6
_GRID = 4             # cells per axis
_CELL_R = 3           # cell half-size in px


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, B) bool -> (K, ceil(B / 32)) int32 words, zero-padded, bit b of
    word w at 32 w + b (the reference's uint32 bit pattern)."""
    k, nbits = bits.shape
    bits = F.pad(bits.to(torch.int32), (0, (-nbits) % 32))
    words = bits.reshape(k, -1, 32)
    weights = torch.ones((), dtype=torch.int32, device=bits.device) << \
        torch.arange(32, dtype=torch.int32, device=bits.device)
    return torch.sum(words * weights, dim=-1, dtype=torch.int32)


def _cell_layout(dev):
    """Cell centres (C, 2) and the cell's pixel offsets (49, 2), x first."""
    centers = (np.mgrid[0:_GRID, 0:_GRID].reshape(2, -1).T -
               (_GRID - 1) / 2.0) * (2 * _CELL_R + 1)
    centers = torch.as_tensor(centers[:, ::-1].astype(np.float32).copy(),
                              device=dev)
    sub_ys, sub_xs = np.mgrid[-_CELL_R:_CELL_R + 1, -_CELL_R:_CELL_R + 1]
    sub = torch.as_tensor(np.stack([sub_xs.ravel(), sub_ys.ravel()], -1)
                          .astype(np.float32), device=dev)
    return centers, sub


def bit_pairs():
    """(channel, cell i, cell j) of each of the 360 descriptor bits: bit
    b is means[channel][:, i] > means[channel][:, j]."""
    iu, ju = np.triu_indices(_GRID * _GRID, k=1)
    chan = np.repeat(np.arange(3), len(iu))
    return chan, np.tile(iu, 3), np.tile(ju, 3)


def akaze_detect_and_describe(gray: torch.Tensor,
                              n_features: int = 4000) -> Features:
    """Detect + describe one (H, W) image into `n_features` masked slots;
    desc is (K, 12) int32."""
    return akaze_with_means(gray, n_features)[0]


def akaze_with_means(gray: torch.Tensor, n_features: int = 4000):
    """(Features, means (3, K, 16)): the cell means of the intensity, dx
    and dy that the descriptor's bits compare (`bit_pairs`)."""
    img = gaussian_blur(gray.to(torch.float32), 1.0, 3)
    dev = img.device
    layers = [img]
    cur = img
    for _ in range(_N_LAYERS - 1):
        for _ in range(_STEPS_PER_LAYER):
            cur = diffusion_step(cur)
        layers.append(cur)
    maps = [det_hessian(lay) * ((i + 1.0) ** 2)
            for i, lay in enumerate(layers)]
    xy, resp, sc, valid = top_k_keypoints(maps, n_features, border=16)

    sel = layers[1]
    gx, gy = central_grad(sel)
    angle = disk_orientation(gx, gy, xy, radius=6, pad=8)

    centers, sub = _cell_layout(dev)
    pad2 = _GRID * (2 * _CELL_R + 1) + 4
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    c0, c1 = centers[None, :, 0], centers[None, :, 1]
    cx = fma(ca, c0, -(sa * c1))                           # (K, C)
    cy = fma(sa, c0, ca * c1)
    sxi = torch.round(xy[:, 0:1, None] + cx[:, :, None] +
                      sub[None, None, :, 0]).to(torch.int64) + pad2
    syi = torch.round(xy[:, 1:2, None] + cy[:, :, None] +
                      sub[None, None, :, 1]).to(torch.int64) + pad2
    means = torch.stack([F.pad(chan, (pad2,) * 4)[syi, sxi].mean(dim=2)
                         for chan in (sel, gx, gy)])      # (3, K, C)
    chan, iu, ju = (torch.as_tensor(x, device=dev) for x in bit_pairs())
    desc = pack_bits((means[chan, :, iu] > means[chan, :, ju]).t())

    return Features(xy=xy, response=torch.where(valid, resp, 0.0),
                    angle=angle, octave=sc,
                    size=(sc.to(torch.float32) + 1.0) * 8.0,
                    desc=desc, valid=valid), means
