"""K1: per-keypoint ORB sampling (IC-angle moments + rBRIEF reads).

Hopper replacement for `image_stitching_tpu/kernels/orb_sample_pallas.py`
(`orb_sample_pallas`).  The CUDA kernel is `csrc/orb_sample.cu`;
`orb_sample_plain` is the same computation in PyTorch ops, written after
the reference's XLA path (`ops/features/orb.py` `_orientations` and
`_describe_impl`): edge-clamped reads, rotation by cos/sin of the atan2
angle, rounding half to even.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._build import check_launch, load_library

__all__ = ["orb_sample", "orb_sample_plain", "pack_bits", "N_SAMPLES"]

N_SAMPLES = 512


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


def _check(img_raw, img_blur, xy, pattern_xy):
    dev = img_raw.device
    for name, t in (("img_raw", img_raw), ("img_blur", img_blur),
                    ("xy", xy), ("pattern_xy", pattern_xy)):
        if t.dtype != torch.float32:
            raise TypeError(f"orb_sample: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"orb_sample: {name} on {t.device}, "
                             f"img_raw on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"orb_sample: {name} must be contiguous")
    if img_raw.ndim != 2 or img_blur.shape != img_raw.shape:
        raise ValueError(f"orb_sample: planes {tuple(img_raw.shape)} / "
                         f"{tuple(img_blur.shape)} must be one (h, w)")
    if xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError(f"orb_sample: xy must be (K, 2), got "
                         f"{tuple(xy.shape)}")
    if tuple(pattern_xy.shape) != (2, N_SAMPLES):
        raise ValueError(f"orb_sample: pattern_xy must be (2, {N_SAMPLES}), "
                         f"got {tuple(pattern_xy.shape)}")


def orb_sample(img_raw: torch.Tensor, img_blur: torch.Tensor,
               xy: torch.Tensor, pattern_xy: torch.Tensor, radius: int):
    """Fused IC-angle moments + rBRIEF samples + descriptor words for one
    level.  img_raw/img_blur (h, w) f32, xy (K, 2) f32 keypoints (x, y),
    pattern_xy (2, 512) f32 endpoint offsets (first points in [:, :256]).
    Returns (samples (K, 512), angle (K,), moments (K, 2), desc (K, 8)
    int32), in the reference wrapper's order plus the descriptor words;
    angle = atan2(m01, m10), the angle the rotation used."""
    _check(img_raw, img_blur, xy, pattern_xy)
    dev = img_raw.device
    if dev.type == "cpu":
        return orb_sample_plain(img_raw, img_blur, xy, pattern_xy, radius)
    if dev.type != "cuda":
        raise ValueError(f"orb_sample: no kernel for device {dev}")
    lib = load_library()
    h, w = img_raw.shape
    k = xy.shape[0]
    samples = torch.empty((k, N_SAMPLES), dtype=torch.float32, device=dev)
    moments = torch.empty((k, 2), dtype=torch.float32, device=dev)
    desc = torch.empty((k, 8), dtype=torch.int32, device=dev)
    code = lib.orb_sample_launch(
        img_raw.data_ptr(), img_blur.data_ptr(), h, w, xy.data_ptr(),
        pattern_xy.data_ptr(), k, int(radius), samples.data_ptr(),
        moments.data_ptr(), desc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "orb_sample")
    orb_sample.launches += 1
    # The kernel rotates by atan2f of the same moments; torch's CUDA
    # atan2 is that libdevice function, so this is the angle it used.
    angle = torch.atan2(moments[:, 1], moments[:, 0])
    return samples, angle, moments, desc


orb_sample.launches = 0
