"""K1: per-keypoint ORB sampling (IC-angle moments + rBRIEF reads).

Hopper replacement for `image_stitching_tpu/kernels/orb_sample_pallas.py`
(`orb_sample_pallas`) and `orb_stream_pallas.py` (K3, the same on planes
past the TPU's VMEM budget).  The CUDA kernel is `csrc/orb_sample.cu`, one
launch over every pyramid level of an image (`orb_sample_levels`);
`orb_sample_plain` is the computation for one level in PyTorch ops,
written after the reference's XLA path (`ops/features/orb.py`
`_orientations` and `_describe_impl`): edge-clamped reads, rotation by
cos/sin of the atan2 angle, rounding half to even.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._build import check_launch, load_library

__all__ = ["orb_sample_levels", "orb_sample_levels_plain",
           "orb_sample_plain", "pack_bits", "N_SAMPLES", "MAX_LEVELS"]

N_SAMPLES = 512
MAX_LEVELS = 8      # level-table entries of one launch
MAX_RADIUS = 31     # the kernel's half-width table


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 descriptor words, LSB first (the
    uint32 words of the reference, same bit pattern)."""
    k = bits.shape[0]
    words = bits.reshape(k, -1, 32).to(torch.int32)
    weights = torch.ones((), dtype=torch.int32, device=bits.device) << \
        torch.arange(32, dtype=torch.int32, device=bits.device)
    return torch.sum(words * weights, dim=-1, dtype=torch.int32)


def _disk_weights(radius: int, device) -> Tuple[torch.Tensor, ...]:
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (xs * xs + ys * ys) <= radius * radius
    wgt = np.stack([(xs * disk).ravel(), (ys * disk).ravel()], -1)
    return (torch.as_tensor(ys.ravel(), device=device),
            torch.as_tensor(xs.ravel(), device=device),
            torch.as_tensor(wgt, dtype=torch.float32, device=device))


def orb_sample_plain(img_raw: torch.Tensor, img_blur: torch.Tensor,
                     xy: torch.Tensor, pattern_xy: torch.Tensor,
                     radius: int):
    """(samples (K, 512) f32, angle (K,) f32, moments (K, 2) f32
    [m10, m01], desc (K, 8) int32) in PyTorch ops."""
    h, w = img_raw.shape
    cx = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    cy = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    dys, dxs, wgt = _disk_weights(radius, img_raw.device)
    rows = torch.clamp(cy[:, None] + dys[None], 0, h - 1)
    cols = torch.clamp(cx[:, None] + dxs[None], 0, w - 1)
    moments = img_raw[rows, cols] @ wgt                       # (K, 2)
    angle = torch.atan2(moments[:, 1], moments[:, 0])
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px, py = pattern_xy[0][None], pattern_xy[1][None]
    rx = ca * px - sa * py
    ry = sa * px + ca * py
    gx = torch.clamp(torch.round(xy[:, 0:1] + rx).to(torch.int64), 0, w - 1)
    gy = torch.clamp(torch.round(xy[:, 1:2] + ry).to(torch.int64), 0, h - 1)
    samples = img_blur[gy, gx]
    half = N_SAMPLES // 2
    return (samples, angle, moments,
            pack_bits(samples[:, :half] < samples[:, half:]))


def orb_sample_levels_plain(raws, blurs, xy: torch.Tensor,
                           level: torch.Tensor, pattern_xy: torch.Tensor,
                           radius: int, with_samples: bool = False):
    """`orb_sample_levels` in PyTorch ops: `orb_sample_plain` on each
    level's keypoints."""
    k = xy.shape[0]
    dev = xy.device
    samples = torch.zeros((k, N_SAMPLES), dtype=torch.float32, device=dev)
    angle = torch.zeros((k,), dtype=torch.float32, device=dev)
    moments = torch.zeros((k, 2), dtype=torch.float32, device=dev)
    desc = torch.zeros((k, 8), dtype=torch.int32, device=dev)
    for lvl, (raw, blur) in enumerate(zip(raws, blurs)):
        sel = level == lvl
        s_l, a_l, m_l, d_l = orb_sample_plain(raw, blur, xy[sel], pattern_xy,
                                              radius)
        samples[sel], angle[sel], moments[sel], desc[sel] = (s_l, a_l, m_l,
                                                             d_l)
    return samples if with_samples else None, angle, moments, desc


def _check(raws, blurs, xy, level, pattern_xy, radius):
    if not 1 <= len(raws) <= MAX_LEVELS or len(blurs) != len(raws):
        raise ValueError(f"orb_sample_levels: 1 to {MAX_LEVELS} levels of "
                         f"(raw, blur) planes, got {len(raws)} and "
                         f"{len(blurs)}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"orb_sample_levels: radius {radius} outside "
                         f"[0, {MAX_RADIUS}]")
    dev = xy.device
    named = [("xy", xy, torch.float32), ("level", level, torch.int32),
             ("pattern_xy", pattern_xy, torch.float32)]
    named += [(f"raws[{i}]", t, torch.float32) for i, t in enumerate(raws)]
    named += [(f"blurs[{i}]", t, torch.float32) for i, t in enumerate(blurs)]
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"orb_sample_levels: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"orb_sample_levels: {name} on {t.device}, xy "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"orb_sample_levels: {name} must be "
                             f"contiguous")
    for i, (raw, blur) in enumerate(zip(raws, blurs)):
        if raw.ndim != 2 or blur.shape != raw.shape:
            raise ValueError(f"orb_sample_levels: level {i} planes "
                             f"{tuple(raw.shape)} / {tuple(blur.shape)} "
                             f"must be one (h, w)")
    if xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError(f"orb_sample_levels: xy must be (K, 2), got "
                         f"{tuple(xy.shape)}")
    if tuple(level.shape) != (xy.shape[0],):
        raise ValueError(f"orb_sample_levels: level must be (K,), got "
                         f"{tuple(level.shape)}")
    if tuple(pattern_xy.shape) != (2, N_SAMPLES):
        raise ValueError(f"orb_sample_levels: pattern_xy must be (2, "
                         f"{N_SAMPLES}), got {tuple(pattern_xy.shape)}")


def orb_sample_levels(raws, blurs, xy: torch.Tensor, level: torch.Tensor,
                      pattern_xy: torch.Tensor, radius: int,
                      with_samples: bool = False):
    """Fused IC-angle moments + rBRIEF samples + descriptor words for the
    keypoints of every pyramid level of one image, in one launch.

    raws/blurs: up to 8 level planes (h_l, w_l) f32 and their sigma-2
    blurs; xy (K, 2) f32 keypoints (x, y) in their level's pixels; level
    (K,) int32 the level of each; pattern_xy (2, 512) f32 endpoint offsets
    (first points in [:, :256]).  Returns (samples (K, 512) or None,
    angle (K,), moments (K, 2) [m10, m01], desc (K, 8) int32); angle =
    atan2(m01, m10), the angle the rotation used.  Samples are written
    only with `with_samples`."""
    _check(raws, blurs, xy, level, pattern_xy, radius)
    dev = xy.device
    if dev.type == "cpu":
        return orb_sample_levels_plain(raws, blurs, xy, level, pattern_xy,
                                       radius, with_samples)
    if dev.type != "cuda":
        raise ValueError(f"orb_sample_levels: no kernel for device {dev}")
    lib = load_library()
    k = xy.shape[0]
    n = len(raws)
    samples = (torch.empty((k, N_SAMPLES), dtype=torch.float32, device=dev)
               if with_samples else None)
    angle = torch.empty((k,), dtype=torch.float32, device=dev)
    moments = torch.empty((k, 2), dtype=torch.float32, device=dev)
    desc = torch.empty((k, 8), dtype=torch.int32, device=dev)
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    code = lib.orb_sample_levels_launch(
        n, ptrs(*(t.data_ptr() for t in raws)),
        ptrs(*(t.data_ptr() for t in blurs)),
        ints(*(t.shape[0] for t in raws)), ints(*(t.shape[1] for t in raws)),
        xy.data_ptr(), level.data_ptr(), pattern_xy.data_ptr(), k,
        int(radius), samples.data_ptr() if with_samples else None,
        angle.data_ptr(), moments.data_ptr(), desc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "orb_sample_levels")
    orb_sample_levels.launches += 1
    return samples, angle, moments, desc


orb_sample_levels.launches = 0
