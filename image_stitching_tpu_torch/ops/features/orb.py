"""ORB detect + describe on torch tensors (port of `ops/features/orb.py`).

Same detector as the reference: 8-level pyramid (scale 1.2), FAST-9/16
corners (threshold 20) found with 16-bit ring masks, Harris ranking
(k = 0.04, block 7) with 3x3 NMS over candidates, exact top-k per level,
a quadratic subpixel fit, and the intensity-centroid angle plus 256-bit
rBRIEF descriptor from kernel K1 (`kernels/orb_sample.py`), one launch
over all levels of an image.  The reference runs K1 only on levels that
fit the TPU's VMEM budget; the CUDA kernel has no such budget.  Each
level's plane, blur, Harris response and NMS-masked rank plane come from
kernel K6 (`kernels/orb_detect.py`), one launch a level; its plain version
is the chain of ops beside it there (`fast_corner_mask`,
`harris_response_map`, `nms_rank`), which this module re-exports.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ...core.logging import span
from ...kernels.orb_detect import (fast_corner_mask, harris_response_map,
                                    nms_rank, orb_detect_maps, pad_edge)
from ...kernels.orb_sample import orb_sample_levels
from ..imgproc import scale_size
from .types import Features

__all__ = ["orb_detect_and_describe", "orb_detect_stack",
           "make_brief_pattern", "make_cv_pattern", "resolve_pattern",
           "fast_corner_mask", "fast_score_map",
           "harris_response_map", "pattern_xy", "nms_rank", "top_k_level",
           "detect_levels", "per_level_counts"]


def make_brief_pattern(patch_size: int = 40, n_bits: int = 256,
                       seed: int = 1234) -> np.ndarray:
    """Seeded Gaussian BRIEF pattern (n_bits, 4) = x1, y1, x2, y2."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2 - 1
    pts = rng.normal(0.0, patch_size / 5.0, size=(n_bits, 4))
    return np.clip(pts, -half, half).astype(np.float32)


def make_cv_pattern() -> np.ndarray:
    """OpenCV's learned bit_pattern_31_ as a (256, 4) float32 table."""
    from .orb_pattern_cv import BIT_PATTERN_31
    return BIT_PATTERN_31.astype(np.float32)


def resolve_pattern(pattern, patch_size: int = 40) -> np.ndarray:
    """None/'gauss' -> seeded Gaussian pattern; 'cv' -> bit_pattern_31_."""
    if pattern is None or (isinstance(pattern, str) and pattern == "gauss"):
        return make_brief_pattern(patch_size)
    if isinstance(pattern, str):
        if pattern == "cv":
            return make_cv_pattern()
        raise ValueError(f"unknown ORB pattern {pattern!r}")
    return np.asarray(pattern, np.float32)


def pattern_xy(pattern: np.ndarray, device) -> torch.Tensor:
    """(256, 4) pattern -> (2, 512) endpoint offsets, first points first."""
    p = np.asarray(pattern, np.float32)
    return torch.as_tensor(np.stack([np.concatenate([p[:, 0], p[:, 2]]),
                                     np.concatenate([p[:, 1], p[:, 3]])]),
                           device=device)


def fast_score_map(img: torch.Tensor, threshold: float = 20.0,
                   arc: int = 9) -> torch.Tensor:
    """The FAST corner mask as a {0, 1} float32 map."""
    return fast_corner_mask(img, threshold, arc).to(torch.float32)


def per_level_counts(n_features: int, n_levels: int,
                     scale_factor: float) -> List[int]:
    """OpenCV ORB feature budget per level: geometric in 1/scale."""
    factor = 1.0 / scale_factor
    ndesired = n_features * (1 - factor) / (1 - factor ** n_levels)
    counts = [int(round(ndesired * factor ** i)) for i in range(n_levels)]
    counts[-1] = max(0, n_features - sum(counts[:-1]))
    return counts


def _subpixel(harris, kyi, kxi):
    """1-D quadratic fit on the Harris surface per axis, clamped to 0.5."""
    hpad = pad_edge(harris, 1)
    hc = hpad[kyi + 1, kxi + 1]
    hl = hpad[kyi + 1, kxi]
    hr = hpad[kyi + 1, kxi + 2]
    ht = hpad[kyi, kxi + 1]
    hb = hpad[kyi + 2, kxi + 1]
    denx = hl - 2.0 * hc + hr
    deny = ht - 2.0 * hc + hb
    okx = torch.abs(denx) > 1e-12
    oky = torch.abs(deny) > 1e-12
    dx = torch.where(okx, 0.5 * (hl - hr) / torch.where(okx, denx, 1.0), 0.0)
    dy = torch.where(oky, 0.5 * (ht - hb) / torch.where(oky, deny, 1.0), 0.0)
    return torch.clamp(dx, -0.5, 0.5), torch.clamp(dy, -0.5, 0.5)


def top_k_level(harris: torch.Tensor, rank: torch.Tensor, k_l: int):
    """Exact top-k_l of the rank plane with lax.top_k's tie order (lower
    index first) and a subpixel fit on the Harris surface.  Returns (xy
    (k_l, 2), response (k_l,), valid (k_l,))."""
    lw = harris.shape[1]
    rank = rank.reshape(-1)
    order = torch.sort(rank, descending=True, stable=True).indices[:k_l]
    top_vals = rank[order]
    kyi = order // lw
    kxi = order % lw
    dx, dy = _subpixel(harris, kyi, kxi)
    xy_l = torch.stack([kxi.to(torch.float32) + dx,
                        kyi.to(torch.float32) + dy], -1).contiguous()
    return xy_l, top_vals, top_vals > -torch.inf


def detect_levels(gray: torch.Tensor, n_features: int = 4000,
                  scale_factor: float = 1.2, n_levels: int = 8,
                  patch_size: int = 40, fast_threshold: float = 20.0):
    """Detect every pyramid level of one (H, W) uint8 or float32 image,
    each level's maps from one `orb_detect_maps` call (K6).  Returns the
    list of (level index, level plane, its sigma-2 blur, xy (k_l, 2) in
    level pixels, response (k_l,), valid (k_l,)) of the levels that take
    keypoints, in level order: what one `orb_sample_levels` call
    describes."""
    gray = gray.contiguous()
    h, w = gray.shape
    counts = per_level_counts(n_features, n_levels, scale_factor)
    levels = []
    for level in range(n_levels):
        lh, lw = scale_size(h, w, 1.0 / scale_factor ** level)
        if min(lh, lw) < patch_size + 8 or counts[level] == 0:
            continue
        with span("orb level"):
            with span("K6", level=level, lh=lh, lw=lw, k=counts[level]):
                img_l, blur, harris, rank = orb_detect_maps(
                    gray, level, lh, lw, patch_size, fast_threshold)
            levels.append((level, img_l, blur) +
                          top_k_level(harris, rank, counts[level]))
    return levels


def orb_detect_and_describe(gray: torch.Tensor, n_features: int = 4000,
                            scale_factor: float = 1.2, n_levels: int = 8,
                            patch_size: int = 40,
                            fast_threshold: float = 20.0,
                            pattern=None) -> Features:
    """Detect + describe one (H, W) float32/uint8 image into exactly
    `n_features` masked slots: every level detected first, then all of
    them described by one `orb_sample_levels` call."""
    with span("orb image"):
        return _orb_detect_and_describe(gray, n_features, scale_factor,
                                        n_levels, patch_size, fast_threshold,
                                        pattern)


def _orb_detect_and_describe(gray, n_features, scale_factor, n_levels,
                             patch_size, fast_threshold, pattern):
    dev = gray.device
    pat = pattern_xy(resolve_pattern(pattern, patch_size), dev)
    levels = detect_levels(gray, n_features, scale_factor, n_levels,
                           patch_size, fast_threshold)
    ks = [lv[3].shape[0] for lv in levels]
    lvl_idx = torch.cat([torch.full((k,), i, dtype=torch.int32, device=dev)
                         for i, k in enumerate(ks)])
    with span("describe (K1)"):
        _, angle, _, desc = orb_sample_levels(
            [lv[1] for lv in levels], [lv[2] for lv in levels],
            torch.cat([lv[3] for lv in levels]), lvl_idx, pat,
            radius=patch_size // 2)
    feats = []
    for (level, _, _, xy_l, top_vals, valid), a_l, d_l in zip(
            levels, angle.split(ks), desc.split(ks)):
        scale = scale_factor ** level
        k_l = xy_l.shape[0]
        feats.append(Features(
            xy=xy_l * scale,
            response=torch.where(valid, top_vals, 0.0),
            angle=a_l,
            octave=torch.full((k_l,), level, dtype=torch.int32, device=dev),
            size=torch.full((k_l,), patch_size * scale, dtype=torch.float32,
                            device=dev),
            desc=d_l, valid=valid))
    out = Features.cat(feats)
    pad_n = n_features - out.xy.shape[0]
    if pad_n > 0:
        out = Features(*(F.pad(t, [0, 0] * (t.ndim - 1) + [0, pad_n])
                         for t in (out.xy, out.response, out.angle,
                                   out.octave, out.size, out.desc,
                                   out.valid)))
    return out


def orb_detect_stack(grays, n_features: int = 4000, **kw) -> Features:
    """Detect + describe each image of a uniform (N, H, W) stack; batched
    Features with leading axis N."""
    return Features.stack([orb_detect_and_describe(g, n_features, **kw)
                           for g in grays])
