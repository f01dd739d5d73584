"""Canvas-sharded compositing, stand-alone (port of `parallel/canvas.py`).

The canvas is split along its width over the devices of a mesh axis.  Each
shard, on its device, evaluates the backward map of its own columns only,
samples every image with a clamp-to-edge bilinear and accumulates its
weighted pixels; the shards run one after another from the host.  Two
composites, both plain tensor ops in the reference as here:
`make_sharded_composite` (a centre-falloff feather weight, then a 5-tap
blur whose 2-column halo is copied from the neighbouring shards' devices)
and `make_sharded_multiband` (each shard recomputes a margin of
3 * 2^n_bands columns, so its pyramid never sees a shard boundary).  The
stitcher's sharded compose is `pipeline/compose_fused.py::
fused_compose_sharded`; these are the reference's simpler composites.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.blend import WEIGHT_EPS, pyr_down, pyr_up
from ..ops.imgproc import fma
from ..ops.warps import PROJECTIONS
from .mesh import Mesh, on_device

__all__ = ["make_sharded_composite", "make_sharded_multiband"]

_HALO = 2
_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _halo_blur(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """5-tap horizontal blur of a canvas split in (H, W_local, C) shards,
    each on its device: every shard takes the _HALO edge columns of its
    left and right neighbours, copied from their devices, and zeros at the
    ends of the line (the reference's ppermute and where)."""
    out = []
    for i, x in enumerate(shards):
        zeros = torch.zeros_like(x[:, :_HALO])
        left = shards[i - 1][:, -_HALO:].to(x.device) if i > 0 else zeros
        right = (shards[i + 1][:, :_HALO].to(x.device)
                 if i < len(shards) - 1 else zeros)
        xp = torch.cat([left, x, right], dim=1)
        w = x.shape[1]
        # The taps add as XLA contracts the reference's sum: one product,
        # then a fused multiply-add per tap.
        acc = _TAPS[0] * xp[:, :w]
        for k in range(1, 5):
            acc = fma(xp[:, k:k + w], _TAPS[k], acc)
        out.append(acc)
    return out


def _clamped_bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """The reference's clamp-to-edge bilinear of an (h, w, C) image at
    (sx, sy): base pixels clamped to the image, the next ones to its last
    row and column, unclamped fractions."""
    h, w = img.shape[0], img.shape[1]
    xi0 = torch.floor(sx)
    yi0 = torch.floor(sy)
    fx = (sx - xi0)[..., None]
    fy = (sy - yi0)[..., None]
    xi = torch.clamp(xi0, 0, w - 1).long()
    yi = torch.clamp(yi0, 0, h - 1).long()
    xi1 = torch.clamp(xi + 1, max=w - 1)
    yi1 = torch.clamp(yi + 1, max=h - 1)
    return (img[yi, xi] * (1 - fx) * (1 - fy) + img[yi, xi1] * fx * (1 - fy)
            + img[yi1, xi] * (1 - fx) * fy + img[yi1, xi1] * fx * fy,
            xi, yi)


def _f32(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _grid(x0: float, width: int, y0: float, height: int, dev):
    us = x0 + torch.arange(width, dtype=torch.float32, device=dev)
    vs = y0 + torch.arange(height, dtype=torch.float32, device=dev)
    return us, vs


def _backward_xy(proj_name: str, us, vs, k, r, scale: float):
    """The reference's `_backward_xy` on the meshgrid of us x vs: source
    coords and validity (z > 0), invalid rays at -1.  The per-pixel form,
    not the separable one of `ops/warps.py::backward_xy_1d`, because the
    two round differently far from the image."""
    uu, vv = torch.meshgrid(us, vs, indexing="xy")
    k_rinv = k @ r.t()
    x_, y_, z_ = PROJECTIONS[proj_name][1](uu / scale, vv / scale)
    px = k_rinv[0, 0] * x_ + k_rinv[0, 1] * y_ + k_rinv[0, 2] * z_
    py = k_rinv[1, 0] * x_ + k_rinv[1, 1] * y_ + k_rinv[1, 2] * z_
    pz = k_rinv[2, 0] * x_ + k_rinv[2, 1] * y_ + k_rinv[2, 2] * z_
    valid = pz > 0
    zs = torch.where(torch.abs(pz) < 1e-12, 1e-12, pz)
    return (torch.where(valid, px / zs, -1.0),
            torch.where(valid, py / zs, -1.0), valid)


def _inside(sx, sy, valid, h: int, w: int):
    return valid & (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)


def make_sharded_composite(mesh: Mesh, n_images: int,
                           src_hw: Tuple[int, int],
                           canvas_hw: Tuple[int, int],
                           canvas_tl: Tuple[int, int], scale: float,
                           proj_name: str = "spherical", axis: str = "sp"):
    """Build the sharded feather composite.  Returns fn(images (N, H, W, 3),
    ks (N, 3, 3), rs (N, 3, 3)) -> canvas (Hc, Wc, 3) float32, gathered on
    the host from the shards of `mesh`'s `axis`; Wc must divide by the
    axis size."""
    hc, wc = canvas_hw
    devs = mesh.axis_devices(axis)
    if wc % len(devs):
        raise ValueError(f"canvas width {wc} does not divide over "
                         f"{len(devs)} shards")
    w_local = wc // len(devs)
    h, w = src_hw

    def local(sidx: int, dev, images, ks, rs):
        us, vs = _grid(canvas_tl[0] + sidx * w_local, w_local, canvas_tl[1],
                       hc, dev)
        acc = torch.zeros((hc, w_local, 3), dtype=torch.float32, device=dev)
        wacc = torch.zeros((hc, w_local), dtype=torch.float32, device=dev)
        for img, k, r in zip(images, ks, rs):
            sx, sy, valid = _backward_xy(proj_name, us, vs, k, r, scale)
            val, _, _ = _clamped_bilinear(img, sx, sy)
            # Separable centre-falloff feather weight in source coords.
            wx = 1.0 - torch.abs(2.0 * sx / (w - 1) - 1.0)
            wy = 1.0 - torch.abs(2.0 * sy / (h - 1) - 1.0)
            wgt = torch.where(_inside(sx, sy, valid, h, w),
                              torch.clamp(wx, min=1e-4)
                              * torch.clamp(wy, min=1e-4), 0.0)
            acc += val * wgt[..., None]
            wacc += wgt
        return acc / torch.clamp(wacc[..., None], min=1e-5)

    def fn(images, ks, rs):
        shards = []
        for sidx, dev in enumerate(devs):
            with on_device(dev):
                shards.append(local(sidx, dev, *(
                    _f32(a, dev) for a in (images, ks, rs))))
        return torch.cat([s.cpu() for s in _halo_blur(shards)], dim=1)
    return fn


def make_sharded_multiband(mesh: Mesh, n_images: int,
                           src_hw: Tuple[int, int],
                           canvas_hw: Tuple[int, int],
                           canvas_tl: Tuple[int, int], scale: float,
                           n_bands: int = 3, proj_name: str = "spherical",
                           axis: str = "sp"):
    """Build the sharded multiband composite: each shard composes its slice
    plus a recomputed margin of 3 * 2^n_bands columns on both sides, with
    per-image source-space weights, normalises and collapses, and keeps
    its slice.  Returns fn(images (N, H, W, 3), ks, rs, weights
    (N, H, W)) -> canvas (Hc, Wc, 3) float32 on the host.  Wc must divide
    by the axis size and its slices by 2^n_bands, Hc by 2^n_bands."""
    hc, wc = canvas_hw
    devs = mesh.axis_devices(axis)
    step = 1 << n_bands
    if wc % len(devs) or (wc // len(devs)) % step or hc % step:
        raise ValueError(f"canvas {hc}x{wc} does not split into "
                         f"{len(devs)} slices of multiples of {step}")
    w_local = wc // len(devs)
    margin = 3 * step
    w_ext = w_local + 2 * margin
    h, w = src_hw

    def local(sidx: int, dev, images, ks, rs, weights):
        us, vs = _grid(canvas_tl[0] + sidx * w_local - margin, w_ext,
                       canvas_tl[1], hc, dev)
        accs = [torch.zeros((hc >> b, w_ext >> b, 3), device=dev)
                for b in range(n_bands + 1)]
        waccs = [torch.zeros((hc >> b, w_ext >> b), device=dev)
                 for b in range(n_bands + 1)]
        for img, k, r, wgt_src in zip(images, ks, rs, weights):
            sx, sy, valid = _backward_xy(proj_name, us, vs, k, r, scale)
            val, xi, yi = _clamped_bilinear(img, sx, sy)
            wgt = torch.where(_inside(sx, sy, valid, h, w), wgt_src[yi, xi],
                              0.0)
            gauss, wg = [val], [wgt]
            for _ in range(n_bands):
                gauss.append(pyr_down(gauss[-1]))
                wg.append(pyr_down(wg[-1]))
            for b in range(n_bands + 1):
                lap = (gauss[b] - pyr_up(gauss[b + 1], gauss[b].shape[:2])
                       if b < n_bands else gauss[b])
                accs[b] += lap * wg[b][..., None]
                waccs[b] += wg[b]
        bands = [accs[b] / (waccs[b][..., None] + WEIGHT_EPS)
                 for b in range(n_bands + 1)]
        out = bands[-1]
        for b in range(n_bands - 1, -1, -1):
            out = pyr_up(out, bands[b].shape[:2]) + bands[b]
        return out[:, margin:margin + w_local, :]

    def fn(images, ks, rs, weights):
        shards = []
        for sidx, dev in enumerate(devs):
            with on_device(dev):
                shards.append(local(sidx, dev, *(
                    _f32(a, dev) for a in (images, ks, rs, weights))).cpu())
        return torch.cat(shards, dim=1)
    return fn
