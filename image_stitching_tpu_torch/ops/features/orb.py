"""ORB detect + describe on torch tensors (port of `ops/features/orb.py`).

Same detector as the reference: 8-level pyramid (scale 1.2), FAST-9/16
corners (threshold 20) found with 16-bit ring masks, Harris ranking
(k = 0.04, block 7) with 3x3 NMS over candidates, exact top-k per level,
a quadratic subpixel fit, and the intensity-centroid angle plus 256-bit
rBRIEF descriptor from kernel K1 (`kernels/orb_sample.py`), one launch
over all levels of an image.  The reference runs K1 only on levels that
fit the TPU's VMEM budget; the CUDA kernel has no such budget.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ...core.logging import span
from ...kernels.orb_sample import orb_sample_levels
from ..imgproc import gaussian_blur, resize, scale_size
from .types import Features

__all__ = ["orb_detect_and_describe", "orb_detect_stack",
           "make_brief_pattern", "make_cv_pattern", "resolve_pattern",
           "fast_corner_mask", "fast_score_map",
           "harris_response_map", "pattern_xy", "detect_level",
           "detect_levels", "per_level_counts"]

_FAST_RING = np.array([
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
    (-1, 3),
], dtype=np.int32)  # (dx, dy), clockwise from 12 o'clock


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


def _pad_edge(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate pad of a (H, W) tensor of any dtype."""
    h, w = x.shape
    rows = torch.clamp(torch.arange(-r, h + r, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-r, w + r, device=x.device), 0, w - 1)
    return x[rows][:, cols]


def fast_corner_mask(img: torch.Tensor, threshold: float = 20.0,
                     arc: int = 9) -> torch.Tensor:
    """FAST-9/16 corner mask: the 16 ring comparisons packed into one
    16-bit plane per polarity, then `arc - 1` rotate-AND steps."""
    h, w = img.shape
    if img.dtype.is_floating_point:
        center = torch.round(img).to(torch.int32)
    else:
        center = img.to(torch.int32)
    pad = _pad_edge(center, 3)
    hi = center + int(threshold)
    lo = center - int(threshold)
    bright = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    for i, (dx, dy) in enumerate(_FAST_RING):
        nb = pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        bright |= (nb > hi).to(torch.int32) << i
        dark |= (nb < lo).to(torch.int32) << i

    def run_ge(bits):
        r = bits
        for _ in range(arc - 1):
            r = r & (((r << 1) | (r >> 15)) & 0xFFFF)
        return r != 0

    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inb = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return (run_ge(bright) | run_ge(dark)) & inb


def fast_score_map(img: torch.Tensor, threshold: float = 20.0,
                   arc: int = 9) -> torch.Tensor:
    """The FAST corner mask as a {0, 1} float32 map."""
    return fast_corner_mask(img, threshold, arc).to(torch.float32)


def harris_response_map(img: torch.Tensor, block: int = 7,
                        k: float = 0.04) -> torch.Tensor:
    """Harris response (Sobel gradients, block-summed products); the box
    sum adds the window row-major like the reference's reduce_window."""
    x = img.to(torch.float32)
    p = _pad_edge(x, 1)
    gx = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) -
          (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2]))
    gy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) -
          (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:]))
    h, w = x.shape
    r = block // 2

    def boxsum(a):
        ap = _pad_edge(a, r)
        acc = torch.zeros_like(a)
        for dy in range(block):
            for dx in range(block):
                acc = acc + ap[dy:dy + h, dx:dx + w]
        return acc
    sxx, syy, sxy = boxsum(gx * gx), boxsum(gy * gy), boxsum(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    scale = 1.0 / (4 * block * 255.0)
    return (det - k * tr * tr) * (scale ** 4)


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
    hpad = _pad_edge(harris, 1)
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


def detect_level(img_l: torch.Tensor, corner_src: torch.Tensor, k_l: int,
                 patch_size: int = 40, fast_threshold: float = 20.0):
    """FAST corners of `corner_src`, ranked by the Harris response of the
    level image `img_l` with 3x3 NMS over candidates, exact top-k_l and a
    subpixel fit.  Returns (xy (k_l, 2), response (k_l,), valid (k_l,))."""
    lh, lw = img_l.shape
    dev = img_l.device
    corner = fast_corner_mask(corner_src, fast_threshold)
    harris = harris_response_map(img_l)
    # NMS over candidates only: non-corners must not suppress corners.
    masked = torch.where(corner, harris, -torch.inf)
    pooled = F.max_pool2d(masked[None, None], 3, stride=1, padding=1)[0, 0]
    border = patch_size // 2 + 2
    yy = torch.arange(lh, device=dev)[:, None]
    xx = torch.arange(lw, device=dev)[None, :]
    inb = ((yy >= border) & (yy < lh - border) &
           (xx >= border) & (xx < lw - border))
    cand = corner & (masked >= pooled) & inb
    rank = torch.where(cand, harris, -torch.inf).reshape(-1)
    # Exact top-k with lax.top_k's tie order (lower index first).
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
    """Detect every pyramid level of one (H, W) image.  Returns the list of
    (level index, level plane, its sigma-2 blur, xy (k_l, 2) in level
    pixels, response (k_l,), valid (k_l,)) of the levels that take
    keypoints, in level order: what one `orb_sample_levels` call
    describes."""
    h, w = gray.shape
    counts = per_level_counts(n_features, n_levels, scale_factor)
    levels = []
    for level in range(n_levels):
        lh, lw = scale_size(h, w, 1.0 / scale_factor ** level)
        if min(lh, lw) < patch_size + 8 or counts[level] == 0:
            continue
        with span("orb level"):
            img_l = (resize(gray, (lh, lw)) if level
                     else gray.to(torch.float32)).contiguous()
            xy_l, top_vals, valid = detect_level(
                img_l, gray if level == 0 else img_l, counts[level],
                patch_size, fast_threshold)
            levels.append((level, img_l,
                           gaussian_blur(img_l, 2.0, 3).contiguous(), xy_l,
                           top_vals, valid))
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
