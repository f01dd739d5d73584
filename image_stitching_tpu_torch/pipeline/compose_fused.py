"""Seam-scale warp and fused multiband compose (port of
`pipeline/compose_fused.py:45,151,215,370,461,536,551`).

Per image, on the device: backward warp of the compose source over a
padded, band-aligned canvas rect (kernel K2, `kernels/warp_gather.py`,
with BORDER_REFLECT), the warp-validity mask, the seam mask sampled at
ratio-scaled warped coordinates, a Laplacian pyramid of the planar
(4, h, w) image + weight, and an accumulate into the canvas band
accumulators.  Then one normalise + collapse.  The rect geometry (gap
3 * 2^nb, band-aligned corners, half-octave bucket dims, canvas clamp) is
host integer arithmetic copied from the reference, because it sets what
the pyramid sees at rect borders.  The reference's `lax.scan` over images
is a Python loop; its `dynamic_update_slice` into the accumulators is an
in-place slice add.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import BlenderType
from ..kernels.warp_gather import warp_bilinear
from ..ops.blend import WEIGHT_EPS, num_bands_for
from ..ops.imgproc import dilate3
from ..ops.pyr_mat import pyr_down_mm, pyr_up_mm
from ..ops.seams import bucket_dim
from ..ops.warps import Warper, backward_xy_1d, result_roi

__all__ = ["warp_stack", "compose_rects", "rect_grid", "fused_compose"]


def _patch_bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """Bilinear sample of (h, w, C) with the reference's clamp semantics:
    a base pixel clamped to [0, n - 2] and a saturated fraction, which
    equals BORDER_REFLECT for in-range samples; far samples take the edge."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    fx = torch.where(x0i < 0, 0.0, torch.where(x0i > w - 2, 1.0, fx))
    fy = torch.where(y0i < 0, 0.0, torch.where(y0i > h - 2, 1.0, fy))
    bx = torch.clamp(x0i, 0, w - 2)
    by = torch.clamp(y0i, 0, h - 2)
    fx = fx[..., None]
    fy = fy[..., None]
    row0 = img[by, bx] * (1 - fx) + img[by, bx + 1] * fx
    row1 = img[by + 1, bx] * (1 - fx) + img[by + 1, bx + 1] * fx
    return row0 * (1 - fy) + row1 * fy


def _valid_mask(sx, sy, valid, hc: int, wc: int):
    """INTER_NEAREST + BORDER_CONSTANT on an all-255 mask: source-rect
    containment of the rounded sample."""
    xr = torch.round(sx)
    yr = torch.round(sy)
    return valid & (xr >= 0) & (xr <= wc - 1) & (yr >= 0) & (yr <= hc - 1)


def rect_grid(tl, pad_h: int, pad_w: int, device):
    us = tl[0] + torch.arange(pad_w, dtype=torch.float32, device=device)
    vs = tl[1] + torch.arange(pad_h, dtype=torch.float32, device=device)
    return us, vs


def warp_stack(images: torch.Tensor, ks: torch.Tensor, rs: torch.Tensor,
               scale: float, tls: torch.Tensor, pad_h: int, pad_w: int):
    """Seam-scale warp of an (N, hc, wc, C) stack onto padded per-image
    rects with top-left corners tls (N, 2).  Returns (warped (N, pad_h,
    pad_w, C) uint8, valid (N, pad_h, pad_w) uint8 in {0, 255})."""
    n, hc, wc = images.shape[0], images.shape[1], images.shape[2]
    warped_all, mask_all = [], []
    for i in range(n):
        us, vs = rect_grid(tls[i], pad_h, pad_w, images.device)
        sx, sy, valid = backward_xy_1d(us, vs, ks[i], rs[i], scale)
        warped = _patch_bilinear(images[i].to(torch.float32), sx, sy)
        wmask = _valid_mask(sx, sy, valid, hc, wc)
        warped = torch.where(wmask[..., None], warped, 0.0)
        warped_all.append(torch.clamp(torch.round(warped), 0.0, 255.0).to(
            torch.uint8))
        mask_all.append(wmask.to(torch.uint8) * 255)
    return torch.stack(warped_all), torch.stack(mask_all)


def _interp_matrix(coords: torch.Tensor, n_src: int) -> torch.Tensor:
    """Dense 1-D bilinear interpolation matrix (n_src, n_out) with zero
    fill: M[i, j] = max(0, 1 - |coords[j] - i|)."""
    i = torch.arange(n_src, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[None, :] - i[:, None]),
                       min=0.0)


def _warp_seam(img, k, r, us, vs, scale, smask, stl, seam_ratio: float):
    """Per-image compose sample on the grid us x vs: the K2 image sample
    (planar (3, h, w)) and the blend weight (h, w) from warp validity and
    the seam mask."""
    hc, wc = img.shape[0], img.shape[1]
    sx, sy, valid = backward_xy_1d(us, vs, k, r, scale)
    warped = warp_bilinear(img, sx.contiguous(), sy.contiguous())
    wmask = _valid_mask(sx, sy, valid, hc, wc)
    ratio = torch.tensor(seam_ratio, dtype=torch.float32, device=us.device)
    mx = us * ratio - stl[0]
    my = vs * ratio - stl[1]
    sval = (_interp_matrix(my, smask.shape[0]).t() @ smask
            @ _interp_matrix(mx, smask.shape[1]))
    weight = torch.where((sval > 0.5) & wmask, 1.0, 0.0)
    return warped, weight


def _accumulate(accs: List[torch.Tensor], images, idxs, ks, rs, scale,
                tls, canvas_tl, seam_masks, seam_tls, seam_ratio, pad_h: int,
                pad_w: int, n_bands: int) -> None:
    """One bucket of images into the band accumulators, in place."""
    for i in idxs:
        us, vs = rect_grid(tls[i], pad_h, pad_w, images.device)
        warped, weight = _warp_seam(images[i], ks[i], rs[i], us, vs, scale,
                                    seam_masks[i], seam_tls[i], seam_ratio)
        gauss = [torch.cat([warped, weight[None]], dim=0)]
        for _ in range(n_bands):
            gauss.append(pyr_down_mm(gauss[-1]))
        off = (tls[i] - canvas_tl).to(torch.int32).tolist()
        for b in range(n_bands + 1):
            g = gauss[b]
            lap = (g - pyr_up_mm(gauss[b + 1], g.shape[1:])
                   if b < n_bands else g)
            w = g[3:4]
            val = torch.cat([lap[:3] * w, w], dim=0)
            gh, gw = g.shape[1], g.shape[2]
            acc = accs[b]
            # dynamic_slice start clamping, as in the reference.
            oy = min(max(off[1] >> b, 0), acc.shape[1] - gh)
            ox = min(max(off[0] >> b, 0), acc.shape[2] - gw)
            acc[:, oy:oy + gh, ox:ox + gw] += val


def _finalize(accs: List[torch.Tensor], n_bands: int):
    """Normalise each band by its weight and collapse the pyramid."""
    bands = [accs[b][:3] / (accs[b][3:4] + WEIGHT_EPS)
             for b in range(n_bands + 1)]
    out = bands[-1]
    for b in range(n_bands - 1, -1, -1):
        out = pyr_up_mm(out, bands[b].shape[1:]) + bands[b]
    out_u8 = torch.clamp(torch.round(out.permute(1, 2, 0)), 0.0, 255.0).to(
        torch.uint8)
    return out_u8, accs[0][3] > WEIGHT_EPS


def _prep_seam_masks(seam_masks: Sequence[np.ndarray], device):
    """Pad the seam masks to one 64-snapped shape and pre-dilate 3x3."""
    sh_pad = -(-max(m.shape[0] for m in seam_masks) // 64) * 64
    sw_pad = -(-max(m.shape[1] for m in seam_masks) // 64) * 64
    smask = np.zeros((len(seam_masks), sh_pad, sw_pad), np.uint8)
    for i, m in enumerate(seam_masks):
        smask[i, :m.shape[0], :m.shape[1]] = (np.asarray(m) > 0)
    return dilate3(torch.as_tensor(smask, device=device).to(torch.float32))


@dataclasses.dataclass
class ComposeRects:
    """Host integer geometry of the fused compose: the canvas rect, the
    band count, the padded canvas dims, each image's band-aligned rect
    corner, and the images of each (pad_h, pad_w) bucket."""
    canvas: Tuple[int, int, int, int]
    n_bands: int
    canvas_h: int
    canvas_w: int
    tls: List[Tuple[int, int]]
    buckets: Dict[Tuple[int, int], List[int]]


def compose_rects(comp_corners, comp_sizes, blend_type: BlenderType,
                  blend_strength: float) -> ComposeRects:
    """The reference's rect geometry (`compose_fused.py:575-615`): gap
    3 * 2^nb around each ROI, band-aligned corners, half-octave bucket dims
    snapped to max(step, 128), clamped to the canvas."""
    n = len(comp_corners)
    canvas = result_roi(comp_corners, comp_sizes)
    n_bands, blend_width = num_bands_for(canvas, blend_strength)
    if blend_type == BlenderType.NO or blend_width < 1.0:
        n_bands = 0
    elif blend_type != BlenderType.MULTI_BAND:
        raise NotImplementedError(
            f"blend_type={blend_type.value!r}: the PyTorch port composes "
            "with the multiband blender only")
    step = 1 << max(n_bands, 1)
    cx, cy, cw, ch = canvas
    quant = max(step, 64)
    canvas_w = -(-cw // quant) * quant
    canvas_h = -(-ch // quant) * quant

    gap = 3 * (1 << n_bands)
    tls, brs = [], []
    for i in range(n):
        tlx = max(cx, comp_corners[i][0] - gap)
        tly = max(cy, comp_corners[i][1] - gap)
        brx = min(cx + canvas_w, comp_corners[i][0] + comp_sizes[i][0] + gap)
        bry = min(cy + canvas_h, comp_corners[i][1] + comp_sizes[i][1] + gap)
        tlx = cx + (((tlx - cx) >> n_bands) << n_bands)
        tly = cy + (((tly - cy) >> n_bands) << n_bands)
        tls.append((tlx, tly))
        brs.append((brx, bry))
    pad_step = max(step, 128)

    def _bdim(v, cap):
        return min(-(-bucket_dim(v) // pad_step) * pad_step, cap)

    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i in range(n):
        bw_i = _bdim(brs[i][0] - tls[i][0], canvas_w)
        bh_i = _bdim(brs[i][1] - tls[i][1], canvas_h)
        buckets.setdefault((int(bh_i), int(bw_i)), []).append(i)
    for (bh_i, bw_i), idxs in buckets.items():
        for i in idxs:
            tls[i] = (min(tls[i][0], cx + canvas_w - bw_i),
                      min(tls[i][1], cy + canvas_h - bh_i))
    return ComposeRects(canvas, int(n_bands), canvas_h, canvas_w, tls,
                        buckets)


def fused_compose(images: torch.Tensor, ks, rs, warper: Warper,
                  comp_corners, comp_sizes, seam_masks, seam_corners,
                  seam_ratio: float, blend_type: BlenderType,
                  blend_strength: float):
    """Compose an (N, hc, wc, 3) stack into the panorama.  Returns
    (panorama float32 (H, W, 3), mask bool (H, W)) on the stack's device."""
    dev = images.device
    g = compose_rects(comp_corners, comp_sizes, blend_type, blend_strength)
    cx, cy, cw, ch = g.canvas
    smask = _prep_seam_masks(seam_masks, dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    images_d = images.to(torch.float32)
    ks_d, rs_d, tls_d, stl_d = f32(ks), f32(rs), f32(g.tls), f32(seam_corners)
    canvas_tl = f32([cx, cy])
    accs = [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b),
                        dtype=torch.float32, device=dev)
            for b in range(g.n_bands + 1)]
    for (bh_i, bw_i), idxs in sorted(g.buckets.items()):
        _accumulate(accs, images_d, idxs, ks_d, rs_d, warper.scale, tls_d,
                    canvas_tl, smask, stl_d, seam_ratio, bh_i, bw_i,
                    g.n_bands)
    pano, mask = _finalize(accs, g.n_bands)
    return pano[:ch, :cw].to(torch.float32), mask[:ch, :cw]
