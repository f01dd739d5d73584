"""K2: compose-scale bilinear warp sample with BORDER_REFLECT.

Hopper replacement for `image_stitching_tpu/kernels/warp_gather_pallas.py`
(`warp_bilinear_pallas`).  The CUDA kernel is `csrc/warp_gather.cu`;
`warp_bilinear_plain` is the reference's CPU path (`gather_sample` in
`pipeline/compose_fused.py:242-268`) in PyTorch ops.  Unlike the TPU kernel
it takes any coordinates, in range or not, so no anchoring is needed.

Tap indices follow that path's integer arithmetic: the floored coordinate
becomes an int32 as XLA converts on the CPU (saturating at the int32
range, NaN to 0), and the right or lower tap is that int32 plus one,
wrapping at 2^31.  A backward map can hold such coordinates: a ray nearly
parallel to a plane or fisheye image plane has a tiny positive depth.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library

__all__ = ["warp_bilinear", "warp_bilinear_plain", "reflect_index",
           "int32_taps"]

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def reflect_index(c: torch.Tensor, n: int) -> torch.Tensor:
    """cv BORDER_REFLECT fold: -1 -> 0, -2 -> 1, n -> n - 1."""
    period = 2 * n
    c = torch.remainder(c, period)
    return torch.where(c >= n, period - 1 - c, c)


def int32_taps(c0: torch.Tensor):
    """(c0, c0 + 1) of a floored float32 coordinate as int64 tensors with
    int32 semantics: c0 converted with saturation and NaN to 0, c0 + 1
    wrapped at 2^31."""
    c = torch.nan_to_num(c0.to(torch.float64), nan=0.0)
    c = torch.clamp(c, _I32_MIN, _I32_MAX).to(torch.int64)
    return c, torch.where(c == _I32_MAX, _I32_MIN, c + 1)


def warp_bilinear_plain(img: torch.Tensor, sx: torch.Tensor,
                        sy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (hc, wc, 3) at (sx, sy) (H, W) ->
    planar (3, H, W), reflecting out-of-range taps."""
    hc, wc = img.shape[0], img.shape[1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i, x1i = int32_taps(x0)
    y0i, y1i = int32_taps(y0)
    x0r, x1r = reflect_index(x0i, wc), reflect_index(x1i, wc)
    y0r, y1r = reflect_index(y0i, hc), reflect_index(y1i, hc)
    i00 = img[y0r, x0r]
    i01 = img[y0r, x1r]
    i10 = img[y1r, x0r]
    i11 = img[y1r, x1r]
    w4 = (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy) +
          i10 * (1 - fx) * fy + i11 * fx * fy)
    return w4.permute(2, 0, 1)


def _check(img, sx, sy):
    for name, t in (("img", img), ("sx", sx), ("sy", sy)):
        if t.dtype != torch.float32:
            raise TypeError(f"warp_bilinear: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"warp_bilinear: {name} on {t.device}, "
                             f"img on {img.device}")
        if not t.is_contiguous():
            raise ValueError(f"warp_bilinear: {name} must be contiguous")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"warp_bilinear: img must be (hc, wc, 3), got "
                         f"{tuple(img.shape)}")
    if sx.ndim != 2 or sy.shape != sx.shape:
        raise ValueError(f"warp_bilinear: sx/sy must be one (H, W), got "
                         f"{tuple(sx.shape)} / {tuple(sy.shape)}")


def warp_bilinear(img: torch.Tensor, sx: torch.Tensor,
                  sy: torch.Tensor) -> torch.Tensor:
    """(3, H, W) float32 bilinear/BORDER_REFLECT sample of img (hc, wc, 3)."""
    _check(img, sx, sy)
    dev = img.device
    if dev.type == "cpu":
        return warp_bilinear_plain(img, sx, sy)
    if dev.type != "cuda":
        raise ValueError(f"warp_bilinear: no kernel for device {dev}")
    lib = load_library()
    h, w = sx.shape
    out = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    code = lib.warp_bilinear_launch(
        img.data_ptr(), img.shape[0], img.shape[1], sx.data_ptr(),
        sy.data_ptr(), h, w, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "warp_bilinear")
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0
