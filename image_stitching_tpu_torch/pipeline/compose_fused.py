"""Seam-scale warp, fused compose and strip-streamed compose (port of
`pipeline/compose_fused.py:45,151,215,332,370,461,496,515,536,551,863`).

Per image, on the device: backward warp of the compose source over a
padded, band-aligned canvas rect (kernel K2, `kernels/warp_gather.py`,
with BORDER_REFLECT), the warp-validity mask, the exposure gain (a
scalar, one per channel, or the block map stretched over the image's ROI),
the seam mask sampled at ratio-scaled warped coordinates (for FEATHER,
the blend weight is then the clipped L1 distance to the nearest invalid
pixel inside the image's ROI), then the Laplacian pyramid of the planar
(4, h, w) image + weight accumulated into the band accumulators (kernel
K5, `kernels/multiband.py`, one call per bucket of same-size rects, or
per chunk of SAMPLE_BUDGET bytes; FEATHER and NO accumulate 0 bands).
Then one normalise + collapse.  `fused_compose_strips` runs the same per
vertical canvas strip, with a recompute margin, and downloads each
finished strip while the next one computes.  The rect geometry (gap
3 * 2^nb, band-aligned corners, half-octave bucket dims, frame clamp, the
strips' cuts) is host integer arithmetic copied from the reference,
because it sets what the pyramid sees at rect borders.  The reference's
`lax.scan` over images is a Python loop, and its power-of-two padding of
a strip's bucket counts (dummy slots that add zero, so XLA compiles
once) is left out.  For warp_type="affine" both warps sample the map of
each camera's affine H split as the warper's ROIs split it
(`ops/warps.py::camera_backward_xy`); the reference's fused path samples
the plane map of the raw H, away from those ROIs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import BlenderType
from ..config import ExposureCompensatorType as ECType
from ..core.logging import span
from ..kernels.multiband import pyramid_accumulate
from ..kernels.warp_gather import warp_bilinear
from ..ops.blend import collapse, num_bands_for
from ..ops.imgproc import dilate3
from ..ops.seams import bucket_dim
from ..kernels.warp_gather import int32_taps
from ..ops.warps import Warper, camera_backward_xy, result_roi
from ..parallel.mesh import on_device

__all__ = ["warp_stack", "compose_rects", "strip_rects", "rect_grid",
           "prep_gains", "compose_samples", "compose_buckets",
           "fused_compose", "fused_compose_strips", "fused_compose_sharded",
           "SAMPLE_BUDGET"]


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
    # The gain scales K2's fresh output in place (one rect of a strip is
    # up to 6144 x 6144 pixels).
    if gain is not None and gain.ndim == 0:
        warped.mul_(gain)
    elif gain is not None and gain.ndim == 1:
        warped.mul_(gain[:, None, None])
    elif gain is not None:
        warped.mul_(_gain_sample(us, vs, gain, gain_grid, gain_roi))
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
    to u8: (panorama u8 (H, W, 3), mask (H, W))."""
    out, mask = collapse(accs, n_bands)
    out = out.round_().clamp_(0.0, 255.0)
    return out.permute(1, 2, 0).to(torch.uint8), mask


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
    """Host integer geometry of one accumulator frame: its rect on the
    canvas (x, y, w, h) (the canvas, or one strip with its margins), the
    band count, the padded frame dims, the band-aligned rect corner of each
    image it holds (indexed by image), and the images of each
    (pad_h, pad_w) bucket."""
    canvas: Tuple[int, int, int, int]
    n_bands: int
    canvas_h: int
    canvas_w: int
    tls: Sequence[Tuple[int, int]]
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


def _padded_rects(comp_corners, comp_sizes, canvas, n_bands: int,
                  canvas_w: int, canvas_h: int):
    """Each image's rect (tlx, tly, brx, bry): its ROI grown by the gap
    3 * 2^nb, cut to the padded canvas, its corner band-aligned."""
    cx, cy = canvas[0], canvas[1]
    gap = 3 * (1 << n_bands)
    rects = []
    for (x, y), (w, h) in zip(comp_corners, comp_sizes):
        tlx = max(cx, x - gap)
        tly = max(cy, y - gap)
        rects.append((cx + (((tlx - cx) >> n_bands) << n_bands),
                      cy + (((tly - cy) >> n_bands) << n_bands),
                      min(cx + canvas_w, x + w + gap),
                      min(cy + canvas_h, y + h + gap)))
    return rects


def _bucketed(rects: Dict[int, Tuple[int, int, int, int]], frame,
              n_bands: int):
    """Bucket the rects {image: (tlx, tly, brx, bry)} of one frame
    (x, y, w, h): half-octave dims snapped to max(2^nb, 128) and capped at
    the frame, each corner pulled in so its bucket's rect fits the frame.
    Returns ({image: corner}, {(pad_h, pad_w): [images]})."""
    x0, y0, fw, fh = frame
    pad_step = max(1 << max(n_bands, 1), 128)

    def _bdim(v, cap):
        return min(-(-bucket_dim(v) // pad_step) * pad_step, cap)
    tls, buckets = {}, {}
    for i, (tlx, tly, brx, bry) in rects.items():
        bw, bh = _bdim(brx - tlx, fw), _bdim(bry - tly, fh)
        buckets.setdefault((int(bh), int(bw)), []).append(i)
        tls[i] = (min(tlx, x0 + fw - bw), min(tly, y0 + fh - bh))
    return tls, buckets


def _quantised(v: int, n_bands: int) -> int:
    """A padded canvas dim: v rounded up to max(2^max(nb, 1), 64)."""
    quant = max(1 << max(n_bands, 1), 64)
    return -(-v // quant) * quant


def compose_rects(comp_corners, comp_sizes, blend_type: BlenderType,
                  blend_strength: float) -> ComposeRects:
    """The reference's rect geometry (`compose_fused.py:575-615`): gap
    3 * 2^nb around each ROI, band-aligned corners, half-octave bucket dims
    snapped to max(step, 128), clamped to the canvas; and the blend's
    parameters."""
    canvas = result_roi(comp_corners, comp_sizes)
    n_bands, sharpness, rounds = _blend_params(canvas, blend_type,
                                               blend_strength)
    canvas_w = _quantised(canvas[2], n_bands)
    canvas_h = _quantised(canvas[3], n_bands)
    rects = _padded_rects(comp_corners, comp_sizes, canvas, n_bands,
                          canvas_w, canvas_h)
    tls, buckets = _bucketed(dict(enumerate(rects)),
                             (canvas[0], canvas[1], canvas_w, canvas_h),
                             n_bands)
    return ComposeRects(canvas, int(n_bands), canvas_h, canvas_w,
                        [tls[i] for i in range(len(rects))], buckets,
                        float(sharpness), int(rounds))


def strip_rects(comp_corners, comp_sizes, blend_type: BlenderType,
                blend_strength: float, strip_w: int):
    """The reference's strip geometry (`compose_fused.py:903-983`): the
    interior width `strip_w` rounded up to the band step, a recompute
    margin of 3 * 2^nb columns (FEATHER: at least 2^rounds, the L1
    distance's reach) rounded up to a band, the global rects with their
    gap on a canvas of n_strips * strip_w columns, each cut to its strip's
    extended columns [x0, x0 + strip_w + 2 margin) and bucketed inside
    that frame.  Returns (strip_w, margin, [ComposeRects of each strip])."""
    canvas = result_roi(comp_corners, comp_sizes)
    n_bands, sharpness, rounds = _blend_params(canvas, blend_type,
                                               blend_strength)
    step = 1 << max(n_bands, 1)
    canvas_h = _quantised(canvas[3], n_bands)
    band = 1 << n_bands
    strip_w = max(-(-strip_w // step) * step, step)
    margin = 3 * band
    if sharpness > 0.0:
        margin = max(margin, 1 << rounds)
    margin = -(-margin // band) * band
    w_ext = strip_w + 2 * margin
    cx, cy = canvas[0], canvas[1]
    n_strips = -(-canvas[2] // strip_w)
    rects = _padded_rects(comp_corners, comp_sizes, canvas, n_bands,
                          n_strips * strip_w, canvas_h)
    strips = []
    for s in range(n_strips):
        x0 = cx + s * strip_w - margin
        cut = {i: (max(tlx, x0), tly, min(brx, x0 + w_ext), bry)
               for i, (tlx, tly, brx, bry) in enumerate(rects)
               if min(brx, x0 + w_ext) > max(tlx, x0)}
        tls, buckets = _bucketed(cut, (x0, cy, w_ext, canvas_h), n_bands)
        strips.append(ComposeRects((x0, cy, w_ext, canvas_h), int(n_bands),
                                   canvas_h, w_ext, tls, buckets,
                                   float(sharpness), int(rounds)))
    return strip_w, margin, strips


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


@dataclasses.dataclass
class _SampleInputs:
    """The per-image device inputs of the compose samples."""
    images: torch.Tensor
    warper: Warper
    seam_ratio: float
    ks: torch.Tensor
    rs: torch.Tensor
    seam_tls: torch.Tensor
    rois: torch.Tensor
    smask: torch.Tensor
    gains: Optional[Tuple[torch.Tensor, ...]]


def _sample_inputs(images, ks, rs, warper, comp_corners, comp_sizes,
                   seam_masks, seam_corners, seam_ratio,
                   compensator) -> _SampleInputs:
    dev = images.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return _SampleInputs(
        images, warper, seam_ratio, f32(ks), f32(rs), f32(seam_corners),
        f32([[c[0], c[1], s[0], s[1]]
             for c, s in zip(comp_corners, comp_sizes)]),
        _prep_seam_masks(seam_masks, dev),
        prep_gains(compensator, comp_corners, comp_sizes, dev))


def _rect_sample(inp: _SampleInputs, g: ComposeRects, i: int, ph: int,
                 pw: int):
    """Image i's sample on its (ph, pw) rect of frame g: (warped planar
    (3, ph, pw) float32, weight (ph, pw), offset (x, y) in the frame).  A
    u8 source is cast alone, never the stack."""
    us, vs = rect_grid(g.tls[i], ph, pw, inp.images.device)
    gain = (None,) * 3 if inp.gains is None else tuple(
        a[i] for a in inp.gains)
    warped, weight = _warp_seam(
        inp.images[i].to(torch.float32), inp.ks[i], inp.rs[i], us, vs,
        inp.warper.scale, inp.smask[i], inp.seam_tls[i], inp.seam_ratio,
        *gain, proj_name=inp.warper.proj_name)
    if g.feather_sharpness > 0.0:
        weight = _feather_weight(weight, us, vs, inp.rois[i],
                                 g.feather_sharpness, g.feather_rounds)
    return (warped.contiguous(), weight,
            (g.tls[i][0] - g.canvas[0], g.tls[i][1] - g.canvas[1]))


def compose_samples(images: torch.Tensor, ks, rs, warper: Warper,
                    comp_corners, comp_sizes, seam_masks, seam_corners,
                    seam_ratio: float, compensator, g: ComposeRects):
    """The compose's sample of each rect, in its order (buckets sorted by
    dims): (warped planar (3, ph, pw) float32, weight (ph, pw),
    band-0 canvas offset (x, y) as host ints) for each image of the
    (N, hc, wc, 3) stack, with the exposure gains of `compensator` (None or
    an ExposureCompensator) and the rect geometry `g` of `compose_rects`."""
    inp = _sample_inputs(images, ks, rs, warper, comp_corners, comp_sizes,
                         seam_masks, seam_corners, seam_ratio, compensator)
    for (ph, pw), idxs in sorted(g.buckets.items()):
        for i in idxs:
            yield _rect_sample(inp, g, i, ph, pw)


# Device bytes of one K5 call's inputs: the chunk's samples and weights and
# the kernel's scratch levels (`_rect_bytes`).  A bucket larger than this
# goes to K5 in chunks, which adds the images in the same order.
SAMPLE_BUDGET = 2 * 2 ** 30


def _rect_bytes(ph: int, pw: int, n_bands: int) -> int:
    """What one rect of a K5 call holds on the device: its planar sample
    and weight (16 B a pixel) and K5's scratch of its levels 1..nb."""
    return 16 * sum((ph >> b) * (pw >> b) for b in range(n_bands + 1))


def _bucket_chunks(inp: _SampleInputs, g: ComposeRects):
    """Each bucket of g, sorted by dims, in chunks of at most
    SAMPLE_BUDGET bytes (`_rect_bytes`, at least one rect): (warped
    (n, 3, ph, pw), weight (n, ph, pw), offsets [(x, y)] * n), each
    sample written into the chunk as it is made."""
    dev = inp.images.device
    for (ph, pw), idxs in sorted(g.buckets.items()):
        per = max(1, SAMPLE_BUDGET // _rect_bytes(ph, pw, g.n_bands))
        for c0 in range(0, len(idxs), per):
            chunk = idxs[c0:c0 + per]
            warped = torch.empty((len(chunk), 3, ph, pw),
                                 dtype=torch.float32, device=dev)
            weight = torch.empty((len(chunk), ph, pw), dtype=torch.float32,
                                 device=dev)
            offs = []
            for j, i in enumerate(chunk):
                w_j, wt_j, off = _rect_sample(inp, g, i, ph, pw)
                warped[j] = w_j
                weight[j] = wt_j
                offs.append(off)
                del w_j, wt_j       # freed before the next rect is made
            yield warped, weight, offs


def compose_buckets(images: torch.Tensor, ks, rs, warper: Warper,
                    comp_corners, comp_sizes, seam_masks, seam_corners,
                    seam_ratio: float, compensator, g: ComposeRects):
    """What the compose hands K5: `compose_samples` stacked per bucket
    into (warped (N, 3, ph, pw), weight (N, ph, pw), band-0 offsets
    [(x, y)] * N), a bucket above SAMPLE_BUDGET bytes in chunks."""
    return _bucket_chunks(_sample_inputs(
        images, ks, rs, warper, comp_corners, comp_sizes, seam_masks,
        seam_corners, seam_ratio, compensator), g)


def _accumulate(inp: _SampleInputs, g: ComposeRects) -> List[torch.Tensor]:
    """The band accumulators of frame g: K5 on each chunk of each bucket
    into fresh (4, canvas_h >> b, canvas_w >> b) planes."""
    accs = [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b),
                        dtype=torch.float32, device=inp.images.device)
            for b in range(g.n_bands + 1)]
    for warped, weight, offs in _bucket_chunks(inp, g):
        with span("K5", n=warped.shape[0], h=warped.shape[2],
                  w=warped.shape[3], bands=g.n_bands):
            pyramid_accumulate(warped, weight, offs, accs, g.n_bands)
        del warped, weight          # freed before the next chunk is made
    return accs


def fused_compose(images: torch.Tensor, ks, rs, warper: Warper,
                  comp_corners, comp_sizes, seam_masks, seam_corners,
                  seam_ratio: float, compensator, blend_type: BlenderType,
                  blend_strength: float):
    """Compose an (N, hc, wc, 3) stack into the panorama, with the
    exposure gains of `compensator` (None or an ExposureCompensator) and
    the blend `blend_type` (multiband, FEATHER or NO): the compose sample
    of each rect, K5 into the band accumulators (one call per bucket, or
    per chunk of SAMPLE_BUDGET bytes, adding overlapping rects in image
    order; 0 bands for FEATHER and NO), then normalise and collapse.
    Returns (panorama float32 (H, W, 3), mask bool (H, W)) on the stack's
    device."""
    g = compose_rects(comp_corners, comp_sizes, blend_type, blend_strength)
    cw, ch = g.canvas[2], g.canvas[3]
    accs = _accumulate(_sample_inputs(
        images, ks, rs, warper, comp_corners, comp_sizes, seam_masks,
        seam_corners, seam_ratio, compensator), g)
    pano, mask = _finalize(accs, g.n_bands)
    return pano[:ch, :cw].to(torch.float32), mask[:ch, :cw]


def _shard_frames(canvas, blend_type: BlenderType, blend_strength: float,
                  n_dev: int, n_images: int):
    """The reference's sharded geometry (`compose_fused.py:687-707`,
    `:803-810`): the canvas width rounded up to n_dev * 2^max(nb, 1) and
    its height to 2^max(nb, 1), w_local = canvas_w / n_dev, a recompute
    margin of max(3 * 2^nb, 2^rounds for FEATHER) on both sides of each
    shard.  Returns (w_local, margin, [ComposeRects of each shard's frame,
    every image sampled over the whole frame])."""
    n_bands, sharpness, rounds = _blend_params(canvas, blend_type,
                                               blend_strength)
    step = 1 << max(n_bands, 1)
    canvas_w = -(-canvas[2] // (n_dev * step)) * (n_dev * step)
    canvas_h = -(-canvas[3] // step) * step
    w_local = canvas_w // n_dev
    margin = max(3 * (1 << n_bands), (1 << rounds) if sharpness > 0 else 0)
    w_ext = w_local + 2 * margin
    frames = []
    for s in range(n_dev):
        x0 = canvas[0] + s * w_local - margin
        frames.append(ComposeRects(
            (x0, canvas[1], w_ext, canvas_h), int(n_bands), canvas_h, w_ext,
            [(x0, canvas[1])] * n_images,
            {(canvas_h, w_ext): list(range(n_images))}, float(sharpness),
            int(rounds)))
    return w_local, margin, frames


def fused_compose_sharded(mesh, images: torch.Tensor, ks, rs,
                          warper: Warper, comp_corners, comp_sizes,
                          seam_masks, seam_corners, seam_ratio: float,
                          compensator, blend_type: BlenderType,
                          blend_strength: float, axis: str = "sp"):
    """`fused_compose` with the canvas width sharded over the devices of
    `mesh`'s `axis` (`compose_fused.py:786`, the canvas-sharded compose).
    Each shard, on its device, samples every image over its whole frame,
    its canvas slice plus the recompute margin (`_shard_frames`), through
    K2 and the per-image body of `fused_compose`, accumulates through K5
    into shard-local band accumulators, normalises and collapses, and
    keeps its slice.  The shards run one after another from the host; the
    slices are gathered on the host.  Returns host numpy arrays (panorama
    float32 (H, W, 3), mask bool (H, W)) cut to the canvas, like the
    reference; interior pixels match `fused_compose` to the pyramid's
    boundary effects, FEATHER exactly."""
    canvas = result_roi(comp_corners, comp_sizes)
    devs = mesh.axis_devices(axis)
    w_local, margin, frames = _shard_frames(
        canvas, blend_type, blend_strength, len(devs), images.shape[0])
    inputs = {}
    panos, masks = [], []
    for dev, g in zip(devs, frames):
        with on_device(dev):
            if dev not in inputs:
                inputs[dev] = _sample_inputs(
                    images.to(dev), ks, rs, warper, comp_corners, comp_sizes,
                    seam_masks, seam_corners, seam_ratio, compensator)
            accs = _accumulate(inputs[dev], g)
            pano_u8, valid = _finalize(accs, g.n_bands)
            del accs
            panos.append(pano_u8[:, margin:margin + w_local].cpu().numpy())
            masks.append(valid[:, margin:margin + w_local].cpu().numpy())
    cw, ch = canvas[2], canvas[3]
    pano = np.concatenate(panos, axis=1)[:ch, :cw].astype(np.float32)
    return pano, np.concatenate(masks, axis=1)[:ch, :cw]


class _StripFetch:
    """Downloads finished strips into the host panorama: on a CUDA device
    each strip's (u8, mask) is copied into pinned host memory on a side
    stream while the next strip computes, and written into `out`/`mask`
    when the strip after it is finished, so at most two finished strips
    stay on the device.  On the CPU the strip is written at once."""

    def __init__(self, out: np.ndarray, mask: np.ndarray, device):
        self.out, self.mask = out, mask
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.pending = []

    def put(self, pano_u8: torch.Tensor, valid: torch.Tensor, x0: int):
        if not self.cuda:
            self._write(pano_u8, valid, x0)
            return
        self.stream.wait_stream(torch.cuda.current_stream(pano_u8.device))
        with torch.cuda.stream(self.stream):
            host = (torch.empty(pano_u8.shape, dtype=torch.uint8,
                                pin_memory=True),
                    torch.empty(valid.shape, dtype=torch.bool,
                                pin_memory=True))
            host[0].copy_(pano_u8, non_blocking=True)
            host[1].copy_(valid, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        # The device tensors are held until their copy has ended.
        self.pending.append((done, host, (pano_u8, valid), x0))
        while len(self.pending) > 1:
            self._drain()

    def _drain(self):
        done, host, _, x0 = self.pending.pop(0)
        done.synchronize()
        self._write(*host, x0)

    def _write(self, pano_u8, valid, x0: int):
        h, w = valid.shape
        self.out[:h, x0:x0 + w] = pano_u8.numpy()
        self.mask[:h, x0:x0 + w] = valid.numpy()

    def finish(self):
        while self.pending:
            self._drain()


def fused_compose_strips(images: torch.Tensor, ks, rs, warper: Warper,
                         comp_corners, comp_sizes, seam_masks, seam_corners,
                         seam_ratio: float, compensator,
                         blend_type: BlenderType, blend_strength: float, *,
                         strip_w: int = 2048, out=None,
                         out_dtype=np.float32):
    """`fused_compose` streamed over vertical canvas strips
    (`compose_fused.py:863`), for canvases too large for whole-canvas band
    accumulators: the device holds one strip's accumulators, one K5 call's
    samples (SAMPLE_BUDGET), the source stack (u8 stays u8) and at most
    two finished strips.  Each strip (`strip_rects`) composes its cut
    rects as `fused_compose` does, with a recompute margin on both sides
    so the pyramid (and the FEATHER distance) never sees the strip's
    edge; its interior columns are kept.  `out` (optional) is a
    preallocated host array (>= ch, >= cw, 3), an np.memmap included,
    that the panorama is written into.  Returns host numpy arrays
    (panorama `out_dtype` (H, W, 3), mask bool (H, W)), like the
    reference; interior pixels match `fused_compose` to the pyramid's
    boundary effects."""
    strip_w, margin, strips = strip_rects(comp_corners, comp_sizes,
                                          blend_type, blend_strength, strip_w)
    cw, ch = result_roi(comp_corners, comp_sizes)[2:]
    if out is None:
        out = np.empty((ch, cw, 3), out_dtype)
    mask = np.empty((ch, cw), bool)
    inp = _sample_inputs(images, ks, rs, warper, comp_corners, comp_sizes,
                         seam_masks, seam_corners, seam_ratio, compensator)
    fetch = _StripFetch(out, mask, images.device)
    for s, g in enumerate(strips):
        accs = _accumulate(inp, g)
        pano_u8, valid = _finalize(accs, g.n_bands)
        del accs
        wv = min(strip_w, cw - s * strip_w)
        fetch.put(pano_u8[:ch, margin:margin + wv].contiguous(),
                  valid[:ch, margin:margin + wv].contiguous(), s * strip_w)
        del pano_u8, valid
    fetch.finish()
    return out, mask
