"""Seam-scale warp and fused compose (port of
`pipeline/compose_fused.py:45,151,215,332,370,461,496,515,536,551`).

Per image, on the device: backward warp of the compose source over a
padded, band-aligned canvas rect (kernel K2, `kernels/warp_gather.py`,
with BORDER_REFLECT), the warp-validity mask, the exposure gain (a
scalar, one per channel, or the block map stretched over the image's ROI),
the seam mask sampled at ratio-scaled warped coordinates (for FEATHER,
the blend weight is then the clipped L1 distance to the nearest invalid
pixel inside the image's ROI), then the Laplacian pyramid of the planar
(4, h, w) image + weight accumulated into the canvas band accumulators
(kernel K5, `kernels/multiband.py`, one call per bucket of same-size
rects; FEATHER and NO accumulate 0 bands).  Then one normalise +
collapse.  The
rect geometry (gap 3 * 2^nb, band-aligned corners, half-octave bucket
dims, canvas clamp) is host integer arithmetic copied from the reference,
because it sets what the pyramid sees at rect borders.  The reference's
`lax.scan` over images is a Python loop.  For warp_type="affine" both
warps sample the map of each camera's affine H split as the warper's ROIs
split it (`ops/warps.py::camera_backward_xy`); the reference's fused path
samples the plane map of the raw H, away from those ROIs.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import BlenderType
from ..config import ExposureCompensatorType as ECType
from ..kernels.multiband import pyramid_accumulate
from ..kernels.warp_gather import warp_bilinear
from ..ops.blend import collapse, num_bands_for
from ..ops.imgproc import dilate3
from ..ops.seams import bucket_dim
from ..kernels.warp_gather import int32_taps
from ..ops.warps import Warper, camera_backward_xy, result_roi

__all__ = ["warp_stack", "compose_rects", "rect_grid", "prep_gains",
           "compose_samples", "compose_buckets", "fused_compose"]


def _patch_bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """Bilinear sample of (h, w, C) with the reference's clamp semantics:
    a base pixel clamped to [0, n - 2] and a saturated fraction, which
    equals BORDER_REFLECT for in-range samples; far samples take the edge."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = int32_taps(x0)[0]
    y0i = int32_taps(y0)[0]
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
               scale: float, tls: torch.Tensor, proj_name: str, pad_h: int,
               pad_w: int):
    """Seam-scale warp of an (N, hc, wc, C) stack onto padded per-image
    rects with top-left corners tls (N, 2), by the projection `proj_name`.
    Returns (warped (N, pad_h, pad_w, C) uint8, valid (N, pad_h, pad_w)
    uint8 in {0, 255})."""
    n, hc, wc = images.shape[0], images.shape[1], images.shape[2]
    warped_all, mask_all = [], []
    for i in range(n):
        us, vs = rect_grid(tls[i], pad_h, pad_w, images.device)
        sx, sy, valid = camera_backward_xy(proj_name, us, vs, ks[i], rs[i],
                                           scale)
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


def _gain_sample(us, vs, gain, gain_grid, gain_roi):
    """The per-image block gain map (Gy_max, Gx_max[, 3]) stretched over
    the image's compose-scale ROI with cv2::resize INTER_LINEAR semantics
    (`_warp_gain_seam`'s "blocks" branch): grid coordinates
    (p + 0.5) * grid / roi_size - 0.5, edge-clamped, as two banded
    interpolation-matrix products.  Returns (1 or 3, len(vs), len(us))."""
    gh_i, gw_i = gain_grid[0], gain_grid[1]
    gx = torch.clamp((us - gain_roi[0] + 0.5) * gw_i / gain_roi[2] - 0.5,
                     min=0.0)
    gx = torch.minimum(gx, gw_i - 1.0)
    gy = torch.clamp((vs - gain_roi[1] + 0.5) * gh_i / gain_roi[3] - 0.5,
                     min=0.0)
    gy = torch.minimum(gy, gh_i - 1.0)
    mv = _interp_matrix(gy, gain.shape[0])
    mu = _interp_matrix(gx, gain.shape[1])
    if gain.ndim == 2:
        return (mv.t() @ gain @ mu)[None]
    return torch.einsum("yv,yxc,xu->cvu", mv, gain, mu)


def _warp_seam(img, k, r, us, vs, scale, smask, stl, seam_ratio: float,
               gain=None, gain_grid=None, gain_roi=None,
               proj_name: str = "spherical"):
    """Per-image compose sample on the grid us x vs: the K2 image sample
    (planar (3, h, w)) times the exposure gain when `gain` is given, and
    the blend weight (h, w) from warp validity and the seam mask.  The
    gain's rank picks `_warp_gain_seam`'s mode: a 0-d GAIN scalar, a (3,)
    CHANNELS triple, or a (Gy, Gx[, 3]) block map sampled over the ROI."""
    hc, wc = img.shape[0], img.shape[1]
    sx, sy, valid = camera_backward_xy(proj_name, us, vs, k, r, scale)
    warped = warp_bilinear(img, sx.contiguous(), sy.contiguous())
    wmask = _valid_mask(sx, sy, valid, hc, wc)
    if gain is not None and gain.ndim == 0:
        warped = warped * gain
    elif gain is not None and gain.ndim == 1:
        warped = warped * gain[:, None, None]
    elif gain is not None:
        warped = warped * _gain_sample(us, vs, gain, gain_grid, gain_roi)
    ratio = torch.tensor(seam_ratio, dtype=torch.float32, device=us.device)
    mx = us * ratio - stl[0]
    my = vs * ratio - stl[1]
    sval = (_interp_matrix(my, smask.shape[0]).t() @ smask
            @ _interp_matrix(mx, smask.shape[1]))
    weight = torch.where((sval > 0.5) & wmask, 1.0, 0.0)
    return warped, weight


def _l1_dist(invalid_seed: torch.Tensor, rounds: int) -> torch.Tensor:
    """Exact L1 distance to the nearest True of `invalid_seed` up to
    2^rounds - 1 (cv2 distanceTransform DIST_L1 inside FeatherBlender's
    createWeightMap), by min-plus doubling along each axis; shifted-in
    wrap-around entries are masked with the big constant."""
    big = 3e8
    d = torch.where(invalid_seed, 0.0, big)
    for axis in (0, 1):
        idx = torch.arange(d.shape[axis], device=d.device)
        shape = [-1, 1] if axis == 0 else [1, -1]
        for k in range(rounds):
            s = 1 << k
            keep_f = (idx >= s).reshape(shape)
            keep_b = (idx < d.shape[axis] - s).reshape(shape)
            fwd = torch.where(keep_f, torch.roll(d, s, dims=axis), big) + s
            bwd = torch.where(keep_b, torch.roll(d, -s, dims=axis), big) + s
            d = torch.minimum(d, torch.minimum(fwd, bwd))
    return d


def _feather_weight(weight, us, vs, roi, sharpness: float, rounds: int):
    """FeatherBlender's weight on the rect: min(d * sharpness, 1) where the
    blend weight is set, d the L1 distance to the nearest unset pixel
    inside the image's compose ROI (x, y, w, h); padding outside the ROI
    seeds no distance."""
    hard = weight > 0.0
    in_box = (((us >= roi[0]) & (us <= roi[0] + roi[2] - 1))[None, :] &
              ((vs >= roi[1]) & (vs <= roi[1] + roi[3] - 1))[:, None])
    d = _l1_dist(~hard & in_box, rounds)
    return torch.clamp(d * sharpness, max=1.0) * hard


def _finalize(accs: List[torch.Tensor], n_bands: int):
    """Normalise each band by its weight, collapse the pyramid and round
    to u8."""
    out, mask = collapse(accs, n_bands)
    out_u8 = torch.clamp(torch.round(out.permute(1, 2, 0)), 0.0, 255.0).to(
        torch.uint8)
    return out_u8, mask


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
    feather_sharpness: float = 0.0
    feather_rounds: int = 0


def _blend_params(canvas, blend_type: BlenderType, blend_strength: float):
    """(n_bands, feather_sharpness, feather_rounds): multiband takes its band count from the canvas and strength; FEATHER
    and NO accumulate 0 bands, FEATHER with the clipped L1 weight map of
    sharpness 1 / blend_width, its doubling rounds covering d <
    blend_width."""
    n_bands, blend_width = num_bands_for(canvas, blend_strength)
    feather_sharpness = 0.0
    feather_rounds = 0
    if blend_type == BlenderType.NO or blend_width < 1.0:
        n_bands = 0
    elif blend_type == BlenderType.FEATHER:
        n_bands = 0
        feather_sharpness = 1.0 / blend_width
        feather_rounds = max(1, int(np.ceil(np.log2(blend_width + 1))))
    return n_bands, feather_sharpness, feather_rounds


def compose_rects(comp_corners, comp_sizes, blend_type: BlenderType,
                  blend_strength: float) -> ComposeRects:
    """The reference's rect geometry (`compose_fused.py:575-615`): gap
    3 * 2^nb around each ROI, band-aligned corners, half-octave bucket dims
    snapped to max(step, 128), clamped to the canvas; and the blend's
    parameters."""
    n = len(comp_corners)
    canvas = result_roi(comp_corners, comp_sizes)
    n_bands, sharpness, rounds = _blend_params(canvas, blend_type,
                                               blend_strength)
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
                        buckets, float(sharpness), int(rounds))


def prep_gains(compensator, comp_corners, comp_sizes, device):
    """Exposure-compensator state -> None (NO) or the compose inputs
    (gains, grids (N, 2), rois (N, 4)) as float32 device tensors
    (`_prep_gains`, `compose_fused.py:515-533`).  gains is (N,) for GAIN,
    (N, 3) for CHANNELS, the block maps (N, Gy, Gx[, 3]) for the *_BLOCKS
    types, each stretched over its image's compose-scale warped ROI."""
    if compensator is None or compensator.comp_type == ECType.NO:
        return None
    rois = [[c[0], c[1], s[0], s[1]] for c, s in zip(comp_corners,
                                                      comp_sizes)]
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (compensator.gains, compensator.grid_sizes, rois))


def compose_samples(images: torch.Tensor, ks, rs, warper: Warper,
                    comp_corners, comp_sizes, seam_masks, seam_corners,
                    seam_ratio: float, compensator, g: ComposeRects):
    """The compose's sample of each rect, in its order (buckets sorted by
    dims): (warped planar (3, ph, pw) float32, weight (ph, pw),
    band-0 canvas offset (x, y) as host ints) for each image of the
    (N, hc, wc, 3) stack, with the exposure gains of `compensator` (None or
    an ExposureCompensator) and the rect geometry `g` of `compose_rects`."""
    dev = images.device
    smask = _prep_seam_masks(seam_masks, dev)
    gains = prep_gains(compensator, comp_corners, comp_sizes, dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ks_d, rs_d, stl_d = f32(ks), f32(rs), f32(seam_corners)
    rois = f32([[c[0], c[1], s[0], s[1]]
                for c, s in zip(comp_corners, comp_sizes)])
    cx, cy = g.canvas[0], g.canvas[1]
    for (bh_i, bw_i), idxs in sorted(g.buckets.items()):
        for i in idxs:
            us, vs = rect_grid(g.tls[i], bh_i, bw_i, dev)
            gain = (None,) * 3 if gains is None else (
                gains[0][i], gains[1][i], gains[2][i])
            warped, weight = _warp_seam(
                images[i].to(torch.float32), ks_d[i], rs_d[i], us, vs,
                warper.scale, smask[i], stl_d[i], seam_ratio, *gain,
                proj_name=warper.proj_name)
            if g.feather_sharpness > 0.0:
                weight = _feather_weight(weight, us, vs, rois[i],
                                         g.feather_sharpness,
                                         g.feather_rounds)
            yield (warped.contiguous(), weight,
                   (g.tls[i][0] - cx, g.tls[i][1] - cy))


def compose_buckets(images: torch.Tensor, ks, rs, warper: Warper,
                    comp_corners, comp_sizes, seam_masks, seam_corners,
                    seam_ratio: float, compensator, g: ComposeRects):
    """What the compose hands K5, bucket by bucket: `compose_samples`
    stacked per bucket into (warped (N, 3, ph, pw), weight (N, ph, pw),
    band-0 offsets [(x, y)] * N).  A bucket's samples are held at once:
    16 * N * ph * pw bytes."""
    for _, rects in itertools.groupby(
            compose_samples(images, ks, rs, warper, comp_corners, comp_sizes,
                            seam_masks, seam_corners, seam_ratio,
                            compensator, g),
            key=lambda r: tuple(r[1].shape)):
        rects = list(rects)
        yield (torch.stack([r[0] for r in rects]),
               torch.stack([r[1] for r in rects]), [r[2] for r in rects])


def fused_compose(images: torch.Tensor, ks, rs, warper: Warper,
                  comp_corners, comp_sizes, seam_masks, seam_corners,
                  seam_ratio: float, compensator, blend_type: BlenderType,
                  blend_strength: float):
    """Compose an (N, hc, wc, 3) stack into the panorama, with the
    exposure gains of `compensator` (None or an ExposureCompensator) and
    the blend `blend_type` (multiband, FEATHER or NO): the compose sample
    of each rect, K5 into the band accumulators (one call per bucket,
    which adds overlapping rects in image order; 0 bands for FEATHER and
    NO), then normalise and collapse.  Returns (panorama float32 (H, W, 3), mask
    bool (H, W)) on the stack's device."""
    dev = images.device
    g = compose_rects(comp_corners, comp_sizes, blend_type, blend_strength)
    cw, ch = g.canvas[2], g.canvas[3]
    accs = [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b),
                        dtype=torch.float32, device=dev)
            for b in range(g.n_bands + 1)]
    for warped, weight, offs in compose_buckets(
            images, ks, rs, warper, comp_corners, comp_sizes, seam_masks,
            seam_corners, seam_ratio, compensator, g):
        pyramid_accumulate(warped, weight, offs, accs, g.n_bands)
    pano, mask = _finalize(accs, g.n_bands)
    return pano[:ch, :cw].to(torch.float32), mask[:ch, :cw]
