"""Rotation warpers of every projection (port of `ops/warps.py`).

The projection table is written once against a numpy-like namespace and
instantiated twice: over numpy, float32, for the host ROI detection and
`warp_point`, copied from the reference so the integer rectangles agree
exactly (border scan, interior grid, date-line rebranch, pole fix); and
over torch, for the backward maps from warped-plane coordinates to source
pixels on the device.  Plane, spherical and cylindrical maps take the
separable form: on an axis-aligned grid the ray factors into functions of
u alone and v alone, so the transcendentals are O(W + H); the other
projections evaluate the meshgrid.  `Warper.warp` warps one image (the
non-uniform branch and the loop compose): its bilinear BORDER_REFLECT
gather is kernel K2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..kernels.warp_gather import int32_taps, warp_bilinear

__all__ = ["Warper", "make_warper", "PROJECTIONS", "backward_xy_1d",
           "camera_backward_xy", "warper_rotations", "result_roi",
           "result_roi_intersection", "u_period"]


class _TorchNS:
    """The numpy names the projection table calls, over torch tensors."""
    pi = math.pi
    sin, cos, tan = torch.sin, torch.cos, torch.tan
    arctan, arctan2 = torch.atan, torch.atan2
    arcsin, arccos = torch.asin, torch.acos
    sqrt, log, exp = torch.sqrt, torch.log, torch.exp
    sinh, cosh, abs = torch.sinh, torch.cosh, torch.abs
    ones_like, where = torch.ones_like, torch.where

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b)

    @staticmethod
    def clip(a, lo, hi):
        return torch.clamp(a, lo, hi)


def _make_projections(xp) -> "Dict[str, Tuple[Callable, Callable]]":
    """name -> (forward: rays (x, y, z) -> unit-scale (u, v), backward:
    (u, v) -> rays), over the namespace xp (numpy or `_TorchNS`)."""
    def _sph_angles(x, y, z):
        """(azimuth u_, polar v_) with v_ = pi - acos(y/r) in [0, pi]."""
        u_ = xp.arctan2(x, z)
        r = xp.sqrt(x * x + y * y + z * z)
        w = xp.clip(y / xp.maximum(r, 1e-30), -1.0, 1.0)
        v_ = xp.pi - xp.arccos(w)
        return u_, v_

    def _elev_angles(x, y, z):
        """(azimuth u_, elevation v_) with v_ = asin(y/r) in [-pi/2, pi/2]."""
        u_ = xp.arctan2(x, z)
        r = xp.sqrt(x * x + y * y + z * z)
        v_ = xp.arcsin(xp.clip(y / xp.maximum(r, 1e-30), -1.0, 1.0))
        return u_, v_

    def _ray_from_elev(u_, v_):
        cv = xp.cos(v_)
        return cv * xp.sin(u_), xp.sin(v_), cv * xp.cos(u_)

    def _plane_fwd(x, y, z):
        zs = xp.where(xp.abs(z) < 1e-12, 1e-12, z)
        return x / zs, y / zs

    def _plane_bwd(u, v):
        return u, v, xp.ones_like(u)

    def _spherical_fwd(x, y, z):
        return _sph_angles(x, y, z)

    def _spherical_bwd(u, v):
        sinv = xp.sin(xp.pi - v)
        return sinv * xp.sin(u), xp.cos(xp.pi - v), sinv * xp.cos(u)

    def _cylindrical_fwd(x, y, z):
        u_ = xp.arctan2(x, z)
        v_ = y / xp.maximum(xp.sqrt(x * x + z * z), 1e-30)
        return u_, v_

    def _cylindrical_bwd(u, v):
        return xp.sin(u), v, xp.cos(u)

    def _fisheye_fwd(x, y, z):
        u_, v_ = _sph_angles(x, y, z)
        return v_ * xp.cos(u_), v_ * xp.sin(u_)

    def _fisheye_bwd(u, v):
        v_ = xp.sqrt(u * u + v * v)
        u_ = xp.arctan2(v, u)
        sinv = xp.sin(xp.pi - v_)
        return sinv * xp.sin(u_), xp.cos(xp.pi - v_), sinv * xp.cos(u_)

    def _stereographic_fwd(x, y, z):
        u_, v_ = _sph_angles(x, y, z)
        # r = sin(v_) / (1 - cos(v_)) = cot(v_/2): projection from the pole.
        r = xp.sin(v_) / xp.maximum(1.0 - xp.cos(v_), 1e-30)
        return r * xp.cos(u_), r * xp.sin(u_)

    def _stereographic_bwd(u, v):
        r = xp.sqrt(u * u + v * v)
        u_ = xp.arctan2(v, u)
        v_ = 2.0 * xp.arctan2(xp.ones_like(r), r)  # = 2*atan(1/r); r=0 -> pi
        sinv = xp.sin(xp.pi - v_)
        return sinv * xp.sin(u_), xp.cos(xp.pi - v_), sinv * xp.cos(u_)

    def _compressed_fwd(a: float, b: float):
        def fwd(x, y, z):
            u_, v_ = _elev_angles(x, y, z)
            u = a * xp.tan(u_ / a)
            v = b * xp.tan(v_) / xp.cos(u_)
            return u, v
        return fwd

    def _compressed_bwd(a: float, b: float):
        def bwd(u, v):
            u_ = a * xp.arctan(u / a)
            v_ = xp.arctan(v * xp.cos(u_) / b)
            return _ray_from_elev(u_, v_)
        return bwd

    def _portrait(fwd_factory, bwd_factory):
        """Portrait variant: the inner projection on the axis-swapped ray
        (y, x, z) with u negated."""
        def make_fwd(a, b):
            inner = fwd_factory(a, b)

            def fwd(x, y, z):
                u, v = inner(y, x, z)
                return -u, v
            return fwd

        def make_bwd(a, b):
            inner = bwd_factory(a, b)

            def bwd(u, v):
                x, y, z = inner(-u, v)
                return y, x, z
            return bwd
        return make_fwd, make_bwd

    _compressed_portrait_fwd, _compressed_portrait_bwd = _portrait(
        _compressed_fwd, _compressed_bwd)

    def _panini_fwd(a: float, b: float):
        def fwd(x, y, z):
            u_, v_ = _elev_angles(x, y, z)
            tg = a * xp.tan(u_ / a)
            sinu = xp.sin(u_)
            ratio = xp.where(xp.abs(sinu) < 1e-7, xp.ones_like(sinu),
                             tg / xp.where(xp.abs(sinu) < 1e-7, 1.0, sinu))
            return tg, b * xp.tan(v_) * ratio
        return fwd

    def _panini_bwd(a: float, b: float):
        def bwd(u, v):
            u_ = a * xp.arctan(u / a)
            tg = a * xp.tan(u_ / a)
            sinu = xp.sin(u_)
            ratio = xp.where(xp.abs(sinu) < 1e-7, xp.ones_like(sinu),
                             tg / xp.where(xp.abs(sinu) < 1e-7, 1.0, sinu))
            v_ = xp.arctan(v / (b * ratio))
            return _ray_from_elev(u_, v_)
        return bwd

    _panini_portrait_fwd, _panini_portrait_bwd = _portrait(_panini_fwd,
                                                           _panini_bwd)

    def _mercator_fwd(x, y, z):
        u_, v_ = _elev_angles(x, y, z)
        v_ = xp.clip(v_, -1.5, 1.5)
        return u_, xp.log(xp.tan(xp.pi / 4.0 + v_ / 2.0))

    def _mercator_bwd(u, v):
        v_ = 2.0 * xp.arctan(xp.exp(v)) - xp.pi / 2.0
        return _ray_from_elev(u, v_)

    def _transverse_mercator_fwd(x, y, z):
        u_, v_ = _elev_angles(x, y, z)
        bb = xp.clip(xp.cos(v_) * xp.sin(u_), -0.999999, 0.999999)
        u = 0.5 * xp.log((1.0 + bb) / (1.0 - bb))
        v = xp.arctan2(xp.tan(v_), xp.cos(u_))
        return u, v

    def _transverse_mercator_bwd(u, v):
        v_ = xp.arcsin(xp.clip(xp.sin(v) / xp.cosh(u), -1.0, 1.0))
        u_ = xp.arctan2(xp.sinh(u), xp.cos(v))
        return _ray_from_elev(u_, v_)

    return {
        "plane": (_plane_fwd, _plane_bwd),
        "affine": (_plane_fwd, _plane_bwd),  # affine folded into R + offset
        "spherical": (_spherical_fwd, _spherical_bwd),
        "cylindrical": (_cylindrical_fwd, _cylindrical_bwd),
        "fisheye": (_fisheye_fwd, _fisheye_bwd),
        "stereographic": (_stereographic_fwd, _stereographic_bwd),
        "compressedPlaneA2B1": (_compressed_fwd(2.0, 1.0),
                                _compressed_bwd(2.0, 1.0)),
        "compressedPlaneA1.5B1": (_compressed_fwd(1.5, 1.0),
                                  _compressed_bwd(1.5, 1.0)),
        "compressedPlanePortraitA2B1": (_compressed_portrait_fwd(2.0, 1.0),
                                        _compressed_portrait_bwd(2.0, 1.0)),
        "compressedPlanePortraitA1.5B1": (
            _compressed_portrait_fwd(1.5, 1.0),
            _compressed_portrait_bwd(1.5, 1.0)),
        "paniniA2B1": (_panini_fwd(2.0, 1.0), _panini_bwd(2.0, 1.0)),
        "paniniA1.5B1": (_panini_fwd(1.5, 1.0), _panini_bwd(1.5, 1.0)),
        "paniniPortraitA2B1": (_panini_portrait_fwd(2.0, 1.0),
                               _panini_portrait_bwd(2.0, 1.0)),
        "paniniPortraitA1.5B1": (_panini_portrait_fwd(1.5, 1.0),
                                 _panini_portrait_bwd(1.5, 1.0)),
        "mercator": (_mercator_fwd, _mercator_bwd),
        "transverseMercator": (_transverse_mercator_fwd,
                               _transverse_mercator_bwd),
    }


PROJECTIONS = _make_projections(_TorchNS)
PROJECTIONS_NP = _make_projections(np)


def _forward_uv_np(proj_name: str, points_xy, k, r, scale: float):
    """Pixel coords (..., 2) -> warped-plane coords, float32 numpy."""
    fwd = PROJECTIONS_NP[proj_name][0]
    k = np.asarray(k, np.float32)
    r = np.asarray(r, np.float32)
    r_kinv = (r @ np.linalg.inv(k)).astype(np.float32)
    pts = np.asarray(points_xy, np.float32)
    p = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
    ray = p @ r_kinv.T
    u, v = fwd(ray[..., 0], ray[..., 1], ray[..., 2])
    return u * np.float32(scale), v * np.float32(scale)


def _sph_bwd_sep(u, v):
    sinv = torch.sin(math.pi - v)[:, None]
    return (sinv * torch.sin(u)[None, :], torch.cos(math.pi - v)[:, None],
            sinv * torch.cos(u)[None, :])


def _cyl_bwd_sep(u, v):
    return torch.sin(u)[None, :], v[:, None], torch.cos(u)[None, :]


def _plane_bwd_sep(u, v):
    return u[None, :], v[:, None], torch.ones((v.shape[0], 1),
                                              dtype=torch.float32,
                                              device=v.device)


SEPARABLE_BWD = {"plane": _plane_bwd_sep, "spherical": _sph_bwd_sep,
                 "cylindrical": _cyl_bwd_sep}


def backward_xy_1d(proj_name: str, us: torch.Tensor, vs: torch.Tensor,
                   k: torch.Tensor, r: torch.Tensor, scale):
    """Source pixel coords (sx, sy) and validity (z > 0) over the grid
    us x vs, each (len(vs), len(us)); invalid rays map to -1.  The
    separable ray factorisation where the projection has one, else the
    projection's backward map on the meshgrid."""
    k_rinv = k.to(torch.float32) @ r.to(torch.float32).t()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=us.device)
    sep = SEPARABLE_BWD.get(proj_name)
    if sep is None:
        uu, vv = torch.meshgrid(us, vs, indexing="xy")
        x_, y_, z_ = PROJECTIONS[proj_name][1](uu / scale, vv / scale)
    else:
        x_, y_, z_ = sep(us / scale, vs / scale)
    px = k_rinv[0, 0] * x_ + k_rinv[0, 1] * y_ + k_rinv[0, 2] * z_
    py = k_rinv[1, 0] * x_ + k_rinv[1, 1] * y_ + k_rinv[1, 2] * z_
    pz = k_rinv[2, 0] * x_ + k_rinv[2, 1] * y_ + k_rinv[2, 2] * z_
    shape = (vs.shape[0], us.shape[0])
    pz = pz.expand(shape)
    valid = pz > 0
    zs = torch.where(torch.abs(pz) < 1e-12, 1e-12, pz)
    return (torch.where(valid, px.expand(shape) / zs, -1.0),
            torch.where(valid, py.expand(shape) / zs, -1.0), valid)


def warper_rotations(proj_name: str, rs) -> np.ndarray:
    """The (N, 3, 3) float32 R that the warper takes for cameras rs.  For
    "affine", each camera holds its image's similarity A into the common
    frame (the convention of the affine estimator and bundle adjuster),
    while the warper splits its R as OpenCV's affine warper does and maps
    p to H_lin^T (p - t_H): the H whose map is exactly A is
    [[A_lin^T, -A_lin^-1 t_A], [0, 0, 1]].  Other projections: rs."""
    rs = np.asarray(rs, np.float32)
    if proj_name != "affine":
        return rs
    a = rs.astype(np.float64)
    lin = a[:, :2, :2]
    h = np.zeros_like(a)
    h[:, :2, :2] = lin.transpose(0, 2, 1)
    h[:, :2, 2] = -np.linalg.solve(lin, a[:, :2, 2:3])[..., 0]
    h[:, 2, 2] = 1.0
    return h.astype(np.float32)


def camera_backward_xy(proj_name: str, us: torch.Tensor, vs: torch.Tensor,
                       k: torch.Tensor, r: torch.Tensor, scale):
    """`backward_xy_1d` for a camera as the warper takes it.  For "affine",
    r is a 3x3 affine H, split as `Warper._prep` splits it for the ROIs
    (the plane projector with R' = H_lin^T and the UV offset
    -scale H_lin^T (t0, t1, 0)), and the map inverts R' exactly: the plane
    map takes R'^T as its inverse, which holds only for a rotation.  Other
    projections pass k and r through."""
    if proj_name != "affine":
        return backward_xy_1d(proj_name, us, vs, k, r, scale)
    lin = r.to(torch.float32).clone()
    t0, t1 = lin[0, 2].clone(), lin[1, 2].clone()
    lin[0, 2] = 0.0
    lin[1, 2] = 0.0
    off_u = -scale * (lin[0, 0] * t0 + lin[1, 0] * t1)
    off_v = -scale * (lin[0, 1] * t0 + lin[1, 1] * t1)
    # backward_xy_1d maps by K r^T; r = inv(R')^T = inv(H_lin).
    return backward_xy_1d(proj_name, us - off_u, vs - off_v, k,
                          torch.linalg.inv(lin), scale)


@dataclasses.dataclass(frozen=True)
class Warper:
    """A rotation warper of a given projection and scale
    (cv::detail::RotationWarper)."""
    proj_name: str
    scale: float

    def _prep(self, k, r):
        """For "affine", `r` is a 3x3 homogeneous affine H: split into its
        linear part (translation zeroed), used transposed as the plane
        projector's R, and a UV offset -scale * H_lin^T (t0, t1, 0)."""
        if self.proj_name == "affine":
            h = np.asarray(r, np.float32).copy()
            t0, t1 = float(h[0, 2]), float(h[1, 2])
            h[0, 2] = 0.0
            h[1, 2] = 0.0
            off = (-self.scale * (h[0, 0] * t0 + h[1, 0] * t1),
                   -self.scale * (h[0, 1] * t0 + h[1, 1] * t1))
            return k, h.T.copy(), off
        return k, r, (0.0, 0.0)

    def detect_result_roi(self, src_hw: Tuple[int, int], k, r):
        """(tl_x, tl_y, br_x, br_y), br inclusive: the source border mapped
        forward (spherical, cylindrical), or the border plus an interior
        grid of step min(h, w) // 16 (the other projections)."""
        h, w = src_hw
        k, r, off = self._prep(k, r)
        xs = np.arange(w, dtype=np.float32)
        ys = np.arange(h, dtype=np.float32)
        border = np.concatenate([
            np.stack([xs, np.zeros_like(xs)], -1),
            np.stack([xs, np.full_like(xs, h - 1)], -1),
            np.stack([np.zeros_like(ys), ys], -1),
            np.stack([np.full_like(ys, w - 1), ys], -1),
        ])
        if self.proj_name in ("spherical", "cylindrical"):
            pts = border
        else:
            step = max(1, min(h, w) // 16)
            gy, gx = np.mgrid[0:h:step, 0:w:step].astype(np.float32)
            interior = np.stack([gx.ravel(), gy.ravel()], -1)
            pts = np.concatenate([border, interior])
        u, v = _forward_uv_np(self.proj_name, pts, k, r, self.scale)
        u = u + off[0]
        v = v + off[1]
        if self.proj_name in ("spherical", "cylindrical", "mercator"):
            # Date-line rebranch: a view straddling azimuth +-pi keeps the
            # tighter of the two branchings.
            period = 2.0 * math.pi * self.scale
            if float(u.max()) - float(u.min()) > 0.5 * period:
                cu, _ = _forward_uv_np(
                    self.proj_name,
                    np.array([[(w - 1) / 2.0, (h - 1) / 2.0]], np.float32),
                    k, r, self.scale)
                cu = float(cu[0]) + off[0]
                u2 = np.mod(u - cu + 0.5 * period, period) - \
                    0.5 * period + cu
                if float(u2.max()) - float(u2.min()) <= 0.5 * period:
                    u = u2
        tl_u, tl_v = float(u.min()), float(v.min())
        br_u, br_v = float(u.max()), float(v.max())
        if self.proj_name == "spherical":
            # Pole fix: a pole inside the source extends the ROI to (0, 0).
            k_rinv = np.asarray(k, np.float64) @ np.asarray(r, np.float64).T
            for pole_y in (1.0, -1.0):
                p = k_rinv @ np.array([0.0, pole_y, 0.0])
                if p[2] > 0:
                    x, y = p[0] / p[2], p[1] / p[2]
                    if 0 < x < w and 0 < y < h:
                        tl_u, br_u = min(tl_u, 0.0), max(br_u, 0.0)
                        tl_v, br_v = min(tl_v, 0.0), max(br_v, 0.0)
        return (int(tl_u), int(tl_v), int(br_u), int(br_v))

    def warp_point(self, xy, k, r):
        """Warped-plane (u, v) of source pixel coords xy (..., 2)."""
        k, r, off = self._prep(k, r)
        u, v = _forward_uv_np(self.proj_name, np.asarray(xy, np.float32),
                              k, r, self.scale)
        return u + off[0], v + off[1]

    def warp_roi(self, src_hw: Tuple[int, int], k, r):
        """dst rect (x, y, width, height), cv::Rect semantics."""
        tlx, tly, brx, bry = self.detect_result_roi(src_hw, k, r)
        return (tlx, tly, brx - tlx + 1, bry - tly + 1)

    def warp(self, src: torch.Tensor, k, r, interp: str = "linear",
             border: str = "reflect", dst_roi=None):
        """warper->warp(src, K, R, interp, border): ((tl_x, tl_y), the
        float32 warped image (H, W[, C]) on src's device).  The dst rect is
        `dst_roi` (x, y, w, h), else the detected ROI.  linear/reflect (the
        images) is kernel K2 on an (h, w, 3) source, zeroed where the ray
        is behind the camera; nearest (the masks) and linear/constant are
        plain gathers.  For "affine", r is the warper's H
        (`warper_rotations`) and the map is `camera_backward_xy`'s."""
        h, w = src.shape[0], src.shape[1]
        if dst_roi is None:
            tlx, tly, brx, bry = self.detect_result_roi((h, w), k, r)
            dst_w, dst_h = brx - tlx + 1, bry - tly + 1
        else:
            tlx, tly, dst_w, dst_h = dst_roi
        dev = src.device
        us = tlx + torch.arange(dst_w, dtype=torch.float32, device=dev)
        vs = tly + torch.arange(dst_h, dtype=torch.float32, device=dev)
        sx, sy, valid = camera_backward_xy(
            self.proj_name, us, vs,
            torch.as_tensor(np.asarray(k, np.float32), device=dev),
            torch.as_tensor(np.asarray(r, np.float32), device=dev),
            self.scale)
        img = src.to(torch.float32)
        if interp == "linear" and border == "reflect":
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError("Warper.warp: linear/reflect takes an "
                                 f"(h, w, 3) image, got {tuple(img.shape)}")
            out = warp_bilinear(img.contiguous(), sx.contiguous(),
                                sy.contiguous())
            out = torch.where(valid, out, 0.0).permute(1, 2, 0)
            return (tlx, tly), out
        flat = img.ndim == 2
        if flat:
            img = img[..., None]
        if interp == "nearest":
            xi = int32_taps(torch.round(sx))[0]
            yi = int32_taps(torch.round(sy))[0]
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & valid
            out = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            if border == "constant":
                out = torch.where(inside[..., None], out, 0.0)
        else:
            x0 = torch.floor(sx)
            y0 = torch.floor(sy)
            fx = (sx - x0)[..., None]
            fy = (sy - y0)[..., None]
            x0i = int32_taps(x0)[0].clamp(-1, w)
            y0i = int32_taps(y0)[0].clamp(-1, h)

            def fetch(yy, xx):
                inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
                val = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
                return torch.where(inside[..., None], val, 0.0)
            out = (fetch(y0i, x0i) * (1 - fx) * (1 - fy) +
                   fetch(y0i, x0i + 1) * fx * (1 - fy) +
                   fetch(y0i + 1, x0i) * (1 - fx) * fy +
                   fetch(y0i + 1, x0i + 1) * fx * fy)
            out = torch.where(valid[..., None], out, 0.0)
        return (tlx, tly), out[..., 0] if flat else out


def u_period(proj_name: str, scale: float):
    """Warped u-axis period in pixels for longitude-linear projections."""
    if proj_name in ("spherical", "cylindrical", "mercator"):
        return int(round(2.0 * math.pi * scale))
    return None


def make_warper(warp_type: str, scale: float) -> Warper:
    if warp_type not in PROJECTIONS:
        raise ValueError(f"Can't create the following warper '{warp_type}'")
    return Warper(warp_type, float(scale))


def result_roi(corners, sizes) -> Tuple[int, int, int, int]:
    """cv::detail::resultRoi: union of per-image rects, (x, y, w, h)."""
    x = min(c[0] for c in corners)
    y = min(c[1] for c in corners)
    xe = max(c[0] + s[0] for c, s in zip(corners, sizes))
    ye = max(c[1] + s[1] for c, s in zip(corners, sizes))
    return (x, y, xe - x, ye - y)


def result_roi_intersection(corners, sizes) -> Tuple[int, int, int, int]:
    """cv::detail::resultRoiIntersection: intersection of the rects."""
    x = max(c[0] for c in corners)
    y = max(c[1] for c in corners)
    xe = min(c[0] + s[0] for c, s in zip(corners, sizes))
    ye = min(c[1] + s[1] for c, s in zip(corners, sizes))
    return (x, y, xe - x, ye - y)
