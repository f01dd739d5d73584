"""SIFT detector/descriptor (port of
`image_stitching_tpu/ops/features/sift.py`).

Gaussian scale space -> DoG extrema over the 3x3x3 neighbourhood with the
contrast and edge-ratio tests -> a quadratic sub-pixel/scale refinement ->
the 36-bin dominant orientation (a second peak at >= 0.8 of the first
adds a copy of the keypoint) -> the 4x4x8 gradient-histogram descriptor
(128 float32, L2-matched).  Every octave offers `n_features` candidates
(twice that with the copies) and a global top-K by |DoG| selects across
octaves.  Expressions round as the reference's XLA CPU contraction does
where it decides a sample or a bin (`imgproc.fma`).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..imgproc import fma, gaussian_blur, resize
from .hessian import central_grad, edge_pad, stable_top_k
from .types import Features

__all__ = ["sift_detect_and_describe", "dog_stack", "extrema_mask",
           "descr_grid", "dominant_orientation", "sift_descriptor"]

_N_SPO = 3            # scales per octave
_SIGMA0 = 1.6
_CONTRAST = 3.4       # OpenCV's 0.04 / 3 on a 0..255 scale
_EDGE_R = 10.0
_ORI_RADIUS = 15      # static orientation window radius
_GRID = 8             # descriptor samples per cell axis
_SCL_FCTR = 3.0       # hist_width = 3 * scl_octv


def dog_stack(img: torch.Tensor, sigma_prev: float = 0.5):
    """One octave: the blurred levels (s + 3) and the DoG stack (s + 2)."""
    k = 2.0 ** (1.0 / _N_SPO)
    gauss = []
    cur = img
    for i in range(_N_SPO + 3):
        sigma_total = _SIGMA0 * (k ** i)
        sigma_diff = math.sqrt(max(sigma_total ** 2 - sigma_prev ** 2, 0.01))
        radius = max(1, min(int(3 * sigma_diff + 0.5), 8))
        cur = gaussian_blur(cur, sigma_diff, radius)
        sigma_prev = sigma_total
        gauss.append(cur)
    dog = torch.stack([gauss[i + 1] - gauss[i] for i in range(_N_SPO + 2)])
    return gauss, dog


def extrema_mask(dog: torch.Tensor) -> torch.Tensor:
    """(S, H, W) -> bool mask of the 26-neighbourhood extrema of the inner
    scales that pass the contrast and edge-ratio tests.  The neighbourhood
    max and min are running maxima over the 26 shifts (exact in any
    order), not a stack of 26 copies."""
    s, h, w = dog.shape
    hi = F.pad(dog, (1, 1, 1, 1, 1, 1), value=-math.inf)
    lo = F.pad(dog, (1, 1, 1, 1, 1, 1), value=math.inf)
    mx = mn = None
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                cut = (slice(1 + ds, 1 + ds + s), slice(1 + dy, 1 + dy + h),
                       slice(1 + dx, 1 + dx + w))
                mx = hi[cut] if mx is None else torch.maximum(mx, hi[cut])
                mn = lo[cut] if mn is None else torch.minimum(mn, lo[cut])
    is_ext = (((dog > mx) & (dog > _CONTRAST)) |
              ((dog < mn) & (dog < -_CONTRAST)))
    del mx, mn, hi, lo
    p = edge_pad(dog, 1)
    dxx = p[:, 1:-1, 2:] + p[:, 1:-1, :-2] - 2 * dog
    dyy = p[:, 2:, 1:-1] + p[:, :-2, 1:-1] - 2 * dog
    dxy = 0.25 * (p[:, 2:, 2:] + p[:, :-2, :-2] - p[:, 2:, :-2] -
                  p[:, :-2, 2:])
    tr = dxx + dyy
    det = fma(dxx, dyy, -(dxy * dxy))
    edge_ok = (det > 0) & (tr * tr * _EDGE_R < (_EDGE_R + 1) ** 2 * det)
    is_ext &= edge_ok
    is_ext[0] = False
    is_ext[-1] = False
    return is_ext


def _fmod_pos(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp.mod: the exact C fmod, shifted into [0, y) when negative."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def dominant_orientation(gx, gy, lvl, xy, scl, radius: int = _ORI_RADIUS):
    """36-bin histogram peak, OpenCV calcOrientationHist semantics.

    gx/gy (L, H, W) gradient stacks; lvl (K,) each keypoint's level.  The
    window is the static (2R+1)^2 grid masked to the per-keypoint square
    radius round(4.5 scl) and weighted by a Gaussian of sigma 1.5 scl;
    samples are soft-binned, the histogram circularly smoothed
    ([1,4,6,4,1]/16) and each peak refined by a parabola.  Returns (angle,
    second angle, has_second): the strongest circular local max not next
    to the first peak, kept at >= 0.8 of it."""
    dev = gx.device
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    ox = torch.as_tensor(xs.ravel(), device=dev)
    oy = torch.as_tensor(ys.ravel(), device=dev)
    r2 = torch.as_tensor((xs ** 2 + ys ** 2).ravel().astype(np.float32),
                         device=dev)
    cheb = torch.as_tensor(np.maximum(np.abs(xs), np.abs(ys)).ravel()
                           .astype(np.float32), device=dev)
    pad = radius + 1
    gxp, gyp = F.pad(gx, (pad,) * 4), F.pad(gy, (pad,) * 4)
    pts = torch.round(xy).to(torch.int64) + pad
    sy = pts[:, None, 1] + oy[None, :]
    sx = pts[:, None, 0] + ox[None, :]
    sl = lvl[:, None].to(torch.int64)
    gxs, gys = gxp[sl, sy, sx], gyp[sl, sy, sx]
    sig = 1.5 * scl[:, None]
    rad_k = torch.round(3.0 * sig)
    wgt = torch.exp(-r2[None, :] / (2.0 * sig * sig)) * \
        (cheb[None, :] <= rad_k)
    mag = torch.sqrt(fma(gxs, gxs, gys * gys)) * wgt
    ang = torch.atan2(gys, gxs)
    fbin = (ang + math.pi) / (2 * math.pi) * 36.0 - 0.5
    b0 = torch.floor(fbin)
    f = fbin - b0
    b0 = torch.remainder(b0.to(torch.int64), 36)
    b1 = torch.remainder(b0 + 1, 36)
    k = xy.shape[0]
    hist = torch.zeros((k, 36), device=dev)
    hist.scatter_add_(1, b0, mag * (1 - f))
    hist.scatter_add_(1, b1, mag * f)
    kern = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=dev) / 16.0
    idx = (torch.arange(36, device=dev)[:, None] +
           torch.arange(-2, 3, device=dev)[None, :]) % 36
    hist = (hist[:, idx] * kern[None, None, :]).sum(-1)

    def at(i):
        return torch.gather(hist, 1, (i % 36)[:, None])[:, 0]

    def refine(peak):
        hl, hc, hr = at(peak - 1), at(peak), at(peak + 1)
        denom = hl - 2 * hc + hr
        ok = torch.abs(denom) > 1e-6
        delta = torch.where(ok, 0.5 * (hl - hr) /
                            torch.where(ok, denom, 1.0), 0.0)
        pk = peak.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
        return (pk + 0.5) / 36.0 * 2 * math.pi - math.pi

    peak = torch.argmax(hist, dim=1)
    left = torch.roll(hist, 1, dims=1)
    right = torch.roll(hist, -1, dims=1)
    localmax = (hist > left) & (hist >= right)
    bins = torch.arange(36, device=dev)[None, :]
    dist = torch.abs((bins - peak[:, None] + 18) % 36 - 18)
    cand = torch.where(localmax & (dist > 1), hist, -1.0)
    peak2 = torch.argmax(cand, dim=1)
    val1 = at(peak)
    val2 = torch.gather(cand, 1, peak2[:, None])[:, 0]
    return refine(peak), refine(peak2), val2 >= 0.8 * val1


def descr_grid() -> Tuple[np.ndarray, np.ndarray]:
    """The static rotated-frame sampling grid in cell units (S, 2) and its
    soft spatial-binning matrix (S, 16): sample s adds cell_w[s, c] of its
    orientation-binned magnitude to cell c (bilinear, with the descriptor
    Gaussian of sigma 2 cells)."""
    n = 4 * _GRID
    ys, xs = (np.mgrid[0:n, 0:n] + 0.5) / _GRID - 2.0
    offs = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    gauss = np.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2) /
                   (2 * 2.0 * 2.0)).astype(np.float32)
    cbin = offs[:, 0] + 1.5
    rbin = offs[:, 1] + 1.5
    c0 = np.floor(cbin).astype(np.int64)
    r0 = np.floor(rbin).astype(np.int64)
    fc = (cbin - c0).astype(np.float32)
    fr = (rbin - r0).astype(np.float32)
    s = offs.shape[0]
    cell_w = np.zeros((s, 16), np.float32)
    for dr, dc in ((0, 0), (0, 1), (1, 0), (1, 1)):
        rr = r0 + dr
        cc = c0 + dc
        wgt = (np.where(dr, fr, 1 - fr) * np.where(dc, fc, 1 - fc) *
               gauss)
        ok = (rr >= 0) & (rr < 4) & (cc >= 0) & (cc < 4)
        idx = np.clip(rr, 0, 3) * 4 + np.clip(cc, 0, 3)
        np.add.at(cell_w, (np.arange(s), idx), np.where(ok, wgt, 0.0))
    return offs, cell_w


def sift_descriptor(gx, gy, lvl, xy, angle, scl) -> torch.Tensor:
    """The 4x4x8 descriptor, Lowe/OpenCV semantics: a window of
    hist_width = 3 scl per cell, gradients bilinearly sampled at the
    rotated fractional positions, trilinear soft binning (the spatial part
    one (16, S) product), normalise, clip at 0.2, normalise."""
    dev = gx.device
    offs_np, cell_w_np = descr_grid()
    offs = torch.as_tensor(offs_np, device=dev)
    cell_w = torch.as_tensor(cell_w_np, device=dev)
    pad = 32
    gxp, gyp = F.pad(gx, (pad,) * 4), F.pad(gy, (pad,) * 4)
    hist_width = torch.clamp(_SCL_FCTR * scl, 1.0, 9.6)[:, None]
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px = offs[None, :, 0] * hist_width
    py = offs[None, :, 1] * hist_width
    rx = fma(ca, px, -(sa * py))
    ry = fma(sa, px, ca * py)
    sxf = xy[:, 0:1] + rx + pad
    syf = xy[:, 1:2] + ry + pad
    x0 = torch.floor(sxf)
    y0 = torch.floor(syf)
    fx = sxf - x0
    fy = syf - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    sl = lvl[:, None].to(torch.int64)

    def samp(p):
        t01 = p[sl, y0i, x0i + 1] * fx * (1 - fy)
        acc = fma(p[sl, y0i, x0i] * (1 - fx), 1 - fy, t01)
        acc = fma(p[sl, y0i + 1, x0i] * (1 - fx), fy, acc)
        return fma(p[sl, y0i + 1, x0i + 1] * fx, fy, acc)
    gxs = samp(gxp)
    gys = samp(gyp)
    mag = torch.sqrt(fma(gxs, gxs, gys * gys))
    ang = torch.atan2(gys, gxs) - angle[:, None]
    fob = _fmod_pos(ang + 2 * math.pi, 2 * math.pi) / (2 * math.pi) * 8.0 \
        - 0.5
    ob0 = torch.floor(fob)
    of = fob - ob0
    ob0i = torch.remainder(ob0.to(torch.int64), 8)
    k, s = mag.shape
    mo = torch.zeros((k, s, 8), device=dev)
    mo.scatter_(2, ob0i[..., None], (mag * (1 - of))[..., None])
    mo.scatter_(2, torch.remainder(ob0i + 1, 8)[..., None],
                (mag * of)[..., None])
    desc = torch.matmul(cell_w.t(), mo).reshape(k, 128)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                              min=1e-6)
    desc = torch.clamp(desc, max=0.2)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                              min=1e-6)


def _refine(dog, sc, kyi, kxi):
    """Brown-Lowe quadratic fit of the DoG's 3x3x3 neighbourhood: the
    offset -H^-1 g (x, y, s), non-finite to 0, clipped to +-0.5."""
    dp = edge_pad(torch.cat([dog[:1], dog, dog[-1:]]), 1)

    def nb(ds, dy, dx):
        return dp[sc + 1 + ds, kyi + 1 + dy, kxi + 1 + dx]
    g1 = 0.5 * (nb(0, 0, 1) - nb(0, 0, -1))
    g2 = 0.5 * (nb(0, 1, 0) - nb(0, -1, 0))
    g3 = 0.5 * (nb(1, 0, 0) - nb(-1, 0, 0))
    c = nb(0, 0, 0)
    hxx = nb(0, 0, 1) + nb(0, 0, -1) - 2 * c
    hyy = nb(0, 1, 0) + nb(0, -1, 0) - 2 * c
    hss = nb(1, 0, 0) + nb(-1, 0, 0) - 2 * c
    hxy = 0.25 * (nb(0, 1, 1) + nb(0, -1, -1) - nb(0, 1, -1) - nb(0, -1, 1))
    hxs = 0.25 * (nb(1, 0, 1) + nb(-1, 0, -1) - nb(1, 0, -1) - nb(-1, 0, 1))
    hys = 0.25 * (nb(1, 1, 0) + nb(-1, -1, 0) - nb(1, -1, 0) - nb(-1, 1, 0))
    hmat = torch.stack([torch.stack([hxx, hxy, hxs], -1),
                        torch.stack([hxy, hyy, hys], -1),
                        torch.stack([hxs, hys, hss], -1)], -2)
    gvec = torch.stack([g1, g2, g3], -1)
    eye = torch.eye(3, dtype=hmat.dtype, device=hmat.device) * 1e-4
    sol, info = torch.linalg.solve_ex(hmat + eye, gvec[..., None])
    off3 = -sol[..., 0]
    ok = torch.isfinite(off3) & (info == 0)[:, None]
    return torch.clamp(torch.where(ok, off3, 0.0), -0.5, 0.5)


def _octave(img, o: int, k_o: int, upsample: bool):
    """Detect one octave: (its 2 k_o candidates in octave pixels, the
    keypoints and their copies at a second histogram peak; the gradient
    stacks (gx, gy) their descriptors sample; the level gauss[_N_SPO]
    that seeds the next octave)."""
    oh, ow = img.shape
    sp = (1.0 if upsample else 0.5) if o == 0 else _SIGMA0
    gauss, dog = dog_stack(img, sigma_prev=sp)
    resp = torch.where(extrema_mask(dog), torch.abs(dog), 0.0)
    vals, idx = stable_top_k(resp.reshape(-1), k_o)
    del resp
    valid = vals > 0
    sc = idx // (oh * ow)
    rem = idx % (oh * ow)
    kyi = rem // ow
    kxi = rem % ow
    off3 = _refine(dog, sc, kyi, kxi)
    del dog
    ky = torch.clamp(kyi.to(torch.float32) + off3[:, 1], 0.0, oh - 1.0)
    kx = torch.clamp(kxi.to(torch.float32) + off3[:, 0], 0.0, ow - 1.0)
    xy = torch.stack([kx, ky], -1)
    gx, gy = central_grad(torch.stack(gauss[1:_N_SPO + 1]))
    lvl = torch.clamp(sc, 1, _N_SPO) - 1
    octv = (sc.to(torch.float32) + off3[:, 2]) / _N_SPO
    scl = _SIGMA0 * torch.pow(2.0, octv)
    angle, angle2, has2 = dominant_orientation(gx, gy, lvl, xy, scl)
    # A second histogram peak adds a copy of the keypoint, ranked just
    # below its primary.
    cand = dict(xy=torch.cat([xy, xy]), lvl=torch.cat([lvl, lvl]),
                scl=torch.cat([scl, scl]), angle=torch.cat([angle, angle2]),
                valid=torch.cat([valid, valid & has2]),
                vals=torch.cat([vals, vals * (1.0 - 1e-6)]),
                octv=torch.cat([octv, octv]),
                octave=torch.full((2 * k_o,), o, dtype=torch.int32,
                                  device=img.device))
    return cand, (gx, gy), gauss[_N_SPO]


def sift_detect_and_describe(gray: torch.Tensor, n_features: int = 4000,
                             n_octaves: int = 4,
                             upsample: bool = False) -> Features:
    """Detect + describe one (H, W) image into `n_features` masked slots;
    desc is (K, 128) float32.  Octaves stop where the short side would
    fall below 32 px (at most `n_octaves`, one more with upsample).  The
    global selection ranks the candidates by response alone, so only the
    selected ones are described, each from its own octave's gradients:
    the reference's output, without the descriptors it drops."""
    h, w = gray.shape[:2]
    base_min = min(h, w) * (2 if upsample else 1)
    n_octaves = min(n_octaves + (1 if upsample else 0),
                    max(1, int(np.log2(base_min / 32)) + 1))
    img = gray.to(torch.float32)
    dev = img.device
    if upsample:
        img = resize(img, (2 * h, 2 * w))
    cands, grads = [], {}
    for o in range(n_octaves):
        oh, ow = img.shape
        if min(oh, ow) >= 32 and n_features > 0:
            cand, grads[o], img = _octave(img, o, n_features, upsample)
            cands.append(cand)
        img = resize(img, (max(oh // 2, 1), max(ow // 2, 1)))
    c = {key: torch.cat([cd[key] for cd in cands]) for key in cands[0]}
    response = torch.where(c["valid"], c["vals"], 0.0)
    if response.shape[0] > n_features:
        _, sel = stable_top_k(torch.where(c["valid"], response, -1.0),
                              n_features)
        c = {key: x[sel] for key, x in c.items()}
        response = response[sel]
    desc = torch.zeros((response.shape[0], 128), device=dev)
    for o, (gx, gy) in grads.items():
        rows = torch.nonzero(c["octave"] == o)[:, 0]
        desc[rows] = sift_descriptor(gx, gy, c["lvl"][rows], c["xy"][rows],
                                     c["angle"][rows], c["scl"][rows])
    octave_scale = torch.pow(2.0, c["octave"].to(torch.float32)) * (
        0.5 if upsample else 1.0)
    out = Features(
        xy=c["xy"] * octave_scale[:, None], response=response,
        angle=c["angle"], octave=c["octave"],
        size=_SIGMA0 * torch.pow(2.0, c["octv"]) * octave_scale * 2.0,
        desc=desc, valid=c["valid"])
    pad_n = n_features - out.xy.shape[0]
    if pad_n > 0:
        out = Features(*(F.pad(x, [0, 0] * (x.ndim - 1) + [0, pad_n])
                         for x in (out.xy, out.response, out.angle,
                                   out.octave, out.size, out.desc,
                                   out.valid)))
    return out
