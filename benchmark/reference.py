"""The plain reference that decides `correct`.

What a stitch returns is judged against what the benchmark made: the
capture sets' ground-truth cameras and their scene.  Plain numpy and torch
(TF32 off); nothing here imports the program, and nothing the program
derived is taken as given: the compose geometry (scales, intrinsics,
regions of interest, canvas) is worked out again from the stitch's
returned cameras, which are themselves held to the ground truth.

- `reproj_px`: the mean pairwise reprojection error of the returned
  cameras against the ground truth, in full-resolution pixels (a copy of
  `bench.py:47 _reproj_err_px` and `:80 _overlapping_pairs`).  It is
  gauge-invariant, so wave correction and BA's global rotation cancel.
- `expected_panorama`: what the panorama must show given those cameras.
  For every kept view, each canvas pixel of its region is mapped back
  through the spherical warper and the view's compose-scale camera (as
  OpenCV's compose stage maps it) to a compose-image pixel, then to the
  full-resolution pixel that compose pixel samples (half-pixel centres,
  per axis), and through the ground-truth camera to the scene.  The
  texture is averaged over a 3 x 3 grid in each canvas pixel; where views
  overlap their expected values are averaged.  The mask is where some
  view's compose image covers the pixel (nearest-pixel rule).
- `compare`: canvas size, mask, and the panorama against the expected
  one after a local least-squares gain over 31 x 31 pixel windows (the
  compensated exposure varies slowly over the canvas: the fitted block
  gains, which `exposure_left_pct` judges, even out each overlap, not
  the whole panorama), the difference blurred twice by a 5 x 5 binomial
  kernel, over the common mask eroded by 4 pixels;
  coverage is compared with the canvas columns folded by the warper's
  u-period, since a canvas wider than 360 degrees holds a direction twice
  and the seams keep one copy.
- `exposure_left_pct`: each view of a capture set has its own exposure
  gain, which the benchmark drew; the exposure layer's fitted gains have
  to even them out where views overlap.  For every overlapping pair, the
  gap in log exposure (drawn gain times the fitted gain map's mean over
  the overlap) after compensation, as a share of the gap before, summed
  over the pairs weighted by overlap area.
- `seam_overlap_pct`: the seam masks a stitch's seam finder returned
  partition the warped views' union, each pixel left to one view; the
  share of the union that two or more masks still claim.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .scene import CaptureSet, lonlat

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUPERSAMPLE = 3
ERODE = 4
GAIN_WINDOW = 31


def reproj_err_px(k_est: np.ndarray, r_est: np.ndarray, kept: Sequence[int],
                  k_true: np.ndarray, rs_true: np.ndarray,
                  hw: Tuple[int, int], pairs=None) -> float:
    """Mean pairwise reprojection error (px) vs the ground truth: for each
    kept pair (a, b) the estimated map K_b R_b^T R_a K_a^-1 against the
    true one, on an 8 x 8 pixel grid.  k_est at full resolution; pairs
    (kept-index pairs) default to consecutive kept images."""
    kc = np.asarray(k_est, np.float64)
    rc = np.asarray(r_est, np.float64)
    h, w = hw
    gy, gx = np.meshgrid(np.linspace(0, h - 1, 8), np.linspace(0, w - 1, 8))
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], axis=0)

    def proj(hmat):
        q = hmat @ pts
        return q[:2] / np.where(np.abs(q[2:]) < 1e-12, 1e-12, q[2:])

    if pairs is None:
        pairs = [(a, a + 1) for a in range(len(kept) - 1)]
    errs = []
    for a, b in pairs:
        h_est = kc[b] @ rc[b].T @ rc[a] @ np.linalg.inv(kc[a])
        ia, ib = kept[a], kept[b]
        h_gt = k_true @ rs_true[ib].T @ rs_true[ia] @ np.linalg.inv(k_true)
        errs.append(np.linalg.norm(proj(h_est) - proj(h_gt), axis=0).mean())
    return float(np.mean(errs)) if errs else float("nan")


def overlapping_pairs(kept: Sequence[int], rs_true: np.ndarray,
                      max_angle_deg: float) -> List[Tuple[int, int]]:
    """Kept-index pairs whose true optical axes lie within max_angle_deg."""
    z = np.stack([np.asarray(rs_true[i], np.float64)[:, 2] for i in kept])
    ang = np.degrees(np.arccos(np.clip(z @ z.T, -1.0, 1.0)))
    return [(a, b) for a in range(len(kept)) for b in range(a + 1, len(kept))
            if ang[a, b] <= max_angle_deg]


def camera_k(cams: Dict[str, np.ndarray]) -> np.ndarray:
    """(N, 3, 3) float64 K from focal, aspect, ppx, ppy."""
    n = len(cams["focal"])
    k = np.zeros((n, 3, 3))
    k[:, 0, 0] = cams["focal"]
    k[:, 1, 1] = np.asarray(cams["focal"], np.float64) * cams["aspect"]
    k[:, 0, 2] = cams["ppx"]
    k[:, 1, 2] = cams["ppy"]
    k[:, 2, 2] = 1.0
    return k


def registration_error(cams: Dict[str, np.ndarray], kept: Sequence[int],
                       work_scale: float, cset: CaptureSet,
                       pair_angle_deg: Optional[float]) -> float:
    """`reproj_err_px` of a stitch's returned (work-scale) cameras; a ring
    takes consecutive kept views, a rig the pairs within pair_angle_deg."""
    k = camera_k(cams)
    k[:, :2, :] /= work_scale
    pairs = None
    if pair_angle_deg is not None:
        pairs = overlapping_pairs(kept, cset.rs, pair_angle_deg) or None
    return reproj_err_px(k, cams["R"], kept, cset.k, cset.rs, cset.hw, pairs)


def _sph_fwd(rays: np.ndarray, scale: float):
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    u = np.arctan2(x, z)
    r = np.sqrt(x * x + y * y + z * z)
    v = np.pi - np.arccos(np.clip(y / np.maximum(r, 1e-30), -1.0, 1.0))
    return scale * u, scale * v


def _round(a, dtype):
    """a (float64) rounded to `dtype` and back; float64 leaves it."""
    if dtype == torch.float64:
        return a
    return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).double(
    ).numpy()


def view_roi(hw: Tuple[int, int], k: np.ndarray, r: np.ndarray,
             scale: float, dtype=torch.float64) -> Tuple[int, int, int, int]:
    """The spherical warper's region (x, y, w, h) of an image of size hw:
    its border pixels mapped forward (a view across azimuth +-pi keeps the
    tighter branching), a pole inside the image extending it to (0, 0),
    corners truncated toward zero as OpenCV's `detectResultRoi` does.
    With a `dtype` below float64, the rays and warped coordinates are
    rounded to it."""
    h, w = hw
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    border = np.concatenate([
        np.stack([xs, np.zeros(w)], -1), np.stack([xs, np.full(w, h - 1.0)],
                                                  -1),
        np.stack([np.zeros(h), ys], -1), np.stack([np.full(h, w - 1.0), ys],
                                                  -1)])
    pts = np.concatenate([border, np.ones((len(border), 1))], -1)
    rkinv = np.asarray(r, np.float64) @ np.linalg.inv(k)
    u, v = _sph_fwd(_round(pts @ rkinv.T, dtype), scale)
    u, v = _round(u, dtype), _round(v, dtype)
    period = 2.0 * math.pi * scale
    if u.max() - u.min() > 0.5 * period:
        cu, _ = _sph_fwd(rkinv @ np.array([(w - 1) / 2.0, (h - 1) / 2.0,
                                           1.0]), scale)
        u2 = np.mod(u - cu + 0.5 * period, period) - 0.5 * period + cu
        if u2.max() - u2.min() <= 0.5 * period:
            u = u2
    tl_u, tl_v, br_u, br_v = u.min(), v.min(), u.max(), v.max()
    k_rinv = np.asarray(k, np.float64) @ np.asarray(r, np.float64).T
    for pole_y in (1.0, -1.0):
        p = k_rinv @ np.array([0.0, pole_y, 0.0])
        if p[2] > 0 and 0 < p[0] / p[2] < w and 0 < p[1] / p[2] < h:
            tl_u, br_u = min(tl_u, 0.0), max(br_u, 0.0)
            tl_v, br_v = min(tl_v, 0.0), max(br_v, 0.0)
    tlx, tly, brx, bry = int(tl_u), int(tl_v), int(br_u), int(br_v)
    return tlx, tly, brx - tlx + 1, bry - tly + 1


def compose_geometry(cams: Dict[str, np.ndarray], work_scale: float,
                     hw: Tuple[int, int], compose_megapix: float,
                     dtype=torch.float64):
    """The compose stage's set-up for full-size images hw: (compose image
    size, compose K per view, warper scale, ROIs, canvas (x, y, w, h)),
    the cameras, scale and warped coordinates rounded to `dtype`."""
    h, w = hw
    scale = 1.0
    if compose_megapix > 0:
        scale = min(1.0, math.sqrt(compose_megapix * 1e6 / (h * w)))
    resized = abs(scale - 1) > 1e-1
    hw_c = ((max(1, int(round(h * scale))), max(1, int(round(w * scale))))
            if resized else (h, w))
    aspect = scale / work_scale
    k = camera_k(cams)
    k[:, 0, :] *= aspect
    k[:, 1, :] *= aspect
    k = _round(k, dtype)
    focals = np.sort(np.asarray(cams["focal"], np.float64))
    n = len(focals)
    med = (focals[n // 2] if n % 2 else
           0.5 * (focals[n // 2 - 1] + focals[n // 2]))
    warp_scale = float(_round(float(med) * aspect, dtype))
    rs = _round(cams["R"], dtype)
    rois = [view_roi(hw_c, k[i], rs[i], warp_scale, dtype)
            for i in range(n)]
    x0 = min(r[0] for r in rois)
    y0 = min(r[1] for r in rois)
    x1 = max(r[0] + r[2] for r in rois)
    y1 = max(r[1] + r[3] for r in rois)
    return hw_c, k, warp_scale, rois, (x0, y0, x1 - x0, y1 - y0)


def expected_panorama(cams: Dict[str, np.ndarray], kept: Sequence[int],
                      work_scale: float, cset: CaptureSet,
                      compose_megapix: float, dtype=torch.float32,
                      rows: int = 256):
    """(expected (H, W, 3), mask (H, W) bool, (canvas (x, y, w, h), the
    warper's u-period in pixels)) of the panorama a stitch with these
    returned cameras must show, computed in `dtype` on the capture set's
    device."""
    dev = cset.texture.device
    tex = cset.texture.astype(dtype)
    hw_c, k_c, scale, rois, canvas = compose_geometry(
        cams, work_scale, cset.hw, compose_megapix,
        torch.float64 if dtype == torch.float32 else dtype)
    x0, y0, cw, ch = canvas
    acc = torch.zeros((ch, cw, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((ch, cw), dtype=torch.float32, device=dev)
    h, w = cset.hw
    sy, sx = hw_c[0] / h, hw_c[1] / w
    offs = (torch.arange(SUPERSAMPLE, device=dev, dtype=torch.float64) + 0.5
            ) / SUPERSAMPLE - 0.5
    kinv_true = np.linalg.inv(cset.k)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(
            dtype)
    for i, view in enumerate(kept):
        rx, ry, rw, rh = rois[i]
        k_rt = t(k_c[i] @ np.asarray(cams["R"][i], np.float64).T)
        rk_true = t(cset.rs[view] @ kinv_true)
        for yy in range(0, rh, rows):
            nrow = min(rows, rh - yy)
            us = torch.arange(rx, rx + rw, device=dev, dtype=torch.float64)
            vs = torch.arange(ry + yy, ry + yy + nrow, device=dev,
                              dtype=torch.float64)
            # (nrow, rw, S, S) sample points around each pixel centre.
            u = (us[None, :, None, None] + offs[None, None, None, :]).to(
                dtype)
            v = (vs[:, None, None, None] + offs[None, None, :, None]).to(
                dtype)
            u, v = torch.broadcast_tensors(u, v)
            a, b = u / scale, v / scale
            sinv = torch.sin(math.pi - b)
            ray = torch.stack([sinv * torch.sin(a), torch.cos(math.pi - b),
                               sinv * torch.cos(a)], -1)
            cam = ray @ k_rt.T
            z = cam[..., 2]
            zs = torch.where(z.abs() < 1e-12, torch.ones_like(z), z)
            qx, qy = cam[..., 0] / zs, cam[..., 1] / zs
            # Full-resolution pixel a compose pixel samples.
            px = (qx + 0.5) / sx - 0.5
            py = (qy + 0.5) / sy - 0.5
            pts = torch.stack([px, py, torch.ones_like(px)], -1)
            lon, lat = lonlat(pts @ rk_true.T)
            val = tex(lon, lat).float().mean(dim=(2, 3))
            c = SUPERSAMPLE // 2
            qc_x, qc_y, zc = qx[:, :, c, c], qy[:, :, c, c], z[:, :, c, c]
            inside = ((zc > 0) & (qc_x >= -0.5) & (qc_x < hw_c[1] - 0.5)
                      & (qc_y >= -0.5) & (qc_y < hw_c[0] - 0.5))
            inside = inside.float()
            # The canvas is the union of the regions, so each lies inside.
            r0, c0 = ry + yy - y0, rx - x0
            acc[r0:r0 + nrow, c0:c0 + rw] += val * inside[..., None]
            cnt[r0:r0 + nrow, c0:c0 + rw] += inside
    mask = cnt > 0
    expected = acc / torch.clamp(cnt, min=1.0)[..., None]
    return expected, mask, (canvas, int(round(2.0 * math.pi * scale)))


def _binomial_blur(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) blurred by the separable 5-tap [1, 4, 6, 4, 1] / 16."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device) / 16.0
    y = x.permute(2, 0, 1)[:, None]
    y = F.conv2d(F.pad(y, (2, 2, 0, 0), mode="replicate"), k.view(1, 1, 1, 5))
    y = F.conv2d(F.pad(y, (0, 0, 2, 2), mode="replicate"), k.view(1, 1, 5, 1))
    return y[:, 0].permute(1, 2, 0)


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """(H, W) summed over the GAIN_WINDOW-square window around each pixel
    (zeros beyond the edges)."""
    r = GAIN_WINDOW // 2
    return F.avg_pool2d(x[None, None], GAIN_WINDOW, 1, r,
                        count_include_pad=True)[0, 0] * GAIN_WINDOW ** 2


def _erode(mask: torch.Tensor, r: int) -> torch.Tensor:
    m = (~mask).float()[None, None]
    return ~(F.max_pool2d(m, 2 * r + 1, 1, r)[0, 0] > 0)


def _folded(mask: torch.Tensor, x0: int, period: int) -> torch.Tensor:
    """The mask's columns OR-ed by canvas x modulo the u-period: where a
    canvas wider than 360 degrees holds a direction twice, the seams keep
    one copy, and either copy covers it."""
    cols = torch.remainder(torch.arange(mask.shape[1], device=mask.device)
                           + x0, period)
    out = torch.zeros((mask.shape[0], period), dtype=torch.float32,
                      device=mask.device)
    out.index_add_(1, cols, mask.float())
    return out > 0


def compare(pano: torch.Tensor, pmask: torch.Tensor, expected: torch.Tensor,
            emask: torch.Tensor, geometry) -> Dict[str, float]:
    """canvas_px: |height difference| + |width difference|; mask_xor_pct:
    the symmetric difference of the masks folded by the u-period, over the
    expected one's folded area (%); pano_mae: mean |blur(pano - g
    expected)| (0..255 levels, over the channels; blurred twice by the
    5-tap binomial, about a 1.4-pixel Gaussian, against sensor noise) over
    the common mask eroded by the blur's radius, g the least-squares
    gain of the GAIN_WINDOW-square window around each pixel.  `geometry`
    is `expected_panorama`'s
    (canvas, period)."""
    (x0, _, _, _), period = geometry
    dev = expected.device
    pano = pano.to(dev, torch.float32)
    pmask = pmask.to(dev).bool()
    canvas_px = abs(pano.shape[0] - expected.shape[0]) + \
        abs(pano.shape[1] - expected.shape[1])
    h = min(pano.shape[0], expected.shape[0])
    w = min(pano.shape[1], expected.shape[1])
    pano, pmask = pano[:h, :w], pmask[:h, :w]
    expected, emask = expected[:h, :w], emask[:h, :w]
    pf, ef = _folded(pmask, x0, period), _folded(emask, x0, period)
    xor = (pf ^ ef).sum().item()
    common = pmask & emask
    region = _erode(common, ERODE)
    n = int(region.sum().item())
    if n == 0:
        return {"canvas_px": float(canvas_px), "mask_xor_pct": 100.0,
                "pano_mae": 255.0}
    sel = common[..., None].float()
    g = _window_sum((pano * expected * sel).sum(-1)) / torch.clamp(
        _window_sum((expected * expected * sel).sum(-1)), min=1e-9)
    diff = _binomial_blur(_binomial_blur((pano - g[..., None] * expected)
                                         * sel))
    mae = float(diff.abs().mean(-1)[region].mean())
    return {"canvas_px": float(canvas_px),
            "mask_xor_pct": 100.0 * xor / max(1, int(ef.sum().item())),
            "pano_mae": mae}


def seam_overlap_pct(corners: Sequence[Tuple[int, int]],
                     masks: Sequence[np.ndarray]) -> float:
    """The share (%) of the seam masks' union, placed at their corners on
    one canvas, that two or more masks claim."""
    x0 = min(c[0] for c in corners)
    y0 = min(c[1] for c in corners)
    x1 = max(c[0] + m.shape[1] for c, m in zip(corners, masks))
    y1 = max(c[1] + m.shape[0] for c, m in zip(corners, masks))
    count = np.zeros((y1 - y0, x1 - x0), np.int32)
    for (x, y), m in zip(corners, masks):
        count[y - y0:y - y0 + m.shape[0], x - x0:x - x0 + m.shape[1]] += \
            np.asarray(m) > 0
    union = int((count > 0).sum())
    return 100.0 * int((count > 1).sum()) / union if union else 100.0


def gain_maps(gains: np.ndarray, grid_sizes: np.ndarray,
              sizes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Each view's gain over its (h, w) warped image: a scalar, the mean
    of its channel gains, or its block grid resized bilinearly over the
    image (half-pixel centres)."""
    out = []
    for i, (h, w) in enumerate(sizes):
        g = torch.as_tensor(np.asarray(gains[i], np.float64))
        if g.ndim == 0 or (g.ndim == 1 and grid_sizes is None) or \
                g.ndim == 1 and len(g) == 3:
            out.append(torch.full((h, w), float(g.mean())))
            continue
        gh, gw = (int(v) for v in grid_sizes[i])
        g = g[:gh, :gw]
        if g.ndim == 3:
            g = g.mean(-1)
        out.append(F.interpolate(g[None, None], size=(h, w),
                                 mode="bilinear", align_corners=False)[0, 0])
    return out


def exposure_left_pct(corners: Sequence[Tuple[int, int]],
                      masks: Sequence[np.ndarray], gains: np.ndarray,
                      grid_sizes: np.ndarray, drawn: np.ndarray) -> float:
    """The exposure gap the fitted gains leave, as a share (%) of the gap
    the drawn exposures make: over every pair of views whose warped masks
    (placed at their corners) overlap, |log(e_i G_i) - log(e_j G_j)| with
    e the drawn gain and G the fitted gain map's mean over the overlap,
    against |log(e_i / e_j)|, each weighted by the overlap's area."""
    sizes = [tuple(m.shape[:2]) for m in masks]
    maps = gain_maps(gains, grid_sizes, sizes)
    left = before = 0.0
    n = len(masks)
    for i in range(n):
        for j in range(i + 1, n):
            (xi, yi), (xj, yj) = corners[i], corners[j]
            x0, y0 = max(xi, xj), max(yi, yj)
            x1 = min(xi + sizes[i][1], xj + sizes[j][1])
            y1 = min(yi + sizes[i][0], yj + sizes[j][0])
            if x1 <= x0 or y1 <= y0:
                continue
            mi = masks[i][y0 - yi:y1 - yi, x0 - xi:x1 - xi] > 0
            mj = masks[j][y0 - yj:y1 - yj, x0 - xj:x1 - xj] > 0
            both = torch.as_tensor(mi & mj)
            area = int(both.sum())
            if area == 0:
                continue
            gi = float(maps[i][y0 - yi:y1 - yi, x0 - xi:x1 - xi][both].mean())
            gj = float(maps[j][y0 - yj:y1 - yj, x0 - xj:x1 - xj][both].mean())
            left += area * abs(math.log(drawn[i] * gi) -
                               math.log(drawn[j] * gj))
            before += area * abs(math.log(drawn[i] / drawn[j]))
    return 100.0 * left / before if before > 0 else 0.0
