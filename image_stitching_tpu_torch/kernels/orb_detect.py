"""K6: one ORB pyramid level's detection maps (level plane, its sigma-2
blur, the Harris response and the NMS-masked rank plane) in one launch.

It replaces no TPU kernel: the JAX package leaves this chain to XLA's
fusion.  The CUDA kernel is `csrc/orb_detect.cu`; `orb_detect_maps_plain`
is the chain of PyTorch ops it replaces (`ops/imgproc.py`'s `resize` and
`gaussian_blur`, and this module's `fast_corner_mask`,
`harris_response_map` and `nms_rank`, which `ops/features/orb.py`
re-exports), equal to it bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.imgproc import gaussian_blur, gaussian_kernel1d, resize
from ._build import check_launch, load_library

__all__ = ["orb_detect_maps", "orb_detect_maps_plain", "KERNEL_CONSTS",
           "fast_corner_mask", "harris_response_map", "nms_rank",
           "pad_edge"]

BLUR_SIGMA, BLUR_RADIUS = 2.0, 3
HARRIS_BLOCK, HARRIS_K = 7, 0.04

# The float32 constants the kernel takes, as the plain ops round them: the
# 7 blur taps, Harris's k and its scale^4.
KERNEL_CONSTS = tuple(
    [float(v) for v in gaussian_kernel1d(BLUR_SIGMA, BLUR_RADIUS)] +
    [float(np.float32(HARRIS_K)),
     float(np.float32((1.0 / (4 * HARRIS_BLOCK * 255.0)) ** 4))])


_FAST_RING = np.array([
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
    (-1, 3),
], dtype=np.int32)  # (dx, dy), clockwise from 12 o'clock


def pad_edge(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate pad of a (H, W) tensor of any dtype."""
    h, w = x.shape
    rows = torch.clamp(torch.arange(-r, h + r, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-r, w + r, device=x.device), 0, w - 1)
    return x[rows][:, cols]


def fast_corner_mask(img: torch.Tensor, threshold: float = 20.0,
                     arc: int = 9) -> torch.Tensor:
    """FAST-9/16 corner mask: the 16 ring comparisons packed into one
    16-bit plane per polarity, then `arc - 1` rotate-AND steps."""
    h, w = img.shape
    if img.dtype.is_floating_point:
        center = torch.round(img).to(torch.int32)
    else:
        center = img.to(torch.int32)
    pad = pad_edge(center, 3)
    hi = center + int(threshold)
    lo = center - int(threshold)
    bright = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    for i, (dx, dy) in enumerate(_FAST_RING):
        nb = pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        bright |= (nb > hi).to(torch.int32) << i
        dark |= (nb < lo).to(torch.int32) << i

    def run_ge(bits):
        r = bits
        for _ in range(arc - 1):
            r = r & (((r << 1) | (r >> 15)) & 0xFFFF)
        return r != 0

    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inb = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return (run_ge(bright) | run_ge(dark)) & inb


def harris_response_map(img: torch.Tensor, block: int = HARRIS_BLOCK,
                        k: float = HARRIS_K) -> torch.Tensor:
    """Harris response (Sobel gradients, block-summed products); the box
    sum adds the window row-major like the reference's reduce_window."""
    x = img.to(torch.float32)
    p = pad_edge(x, 1)
    gx = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) -
          (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2]))
    gy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) -
          (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:]))
    h, w = x.shape
    r = block // 2

    def boxsum(a):
        ap = pad_edge(a, r)
        acc = torch.zeros_like(a)
        for dy in range(block):
            for dx in range(block):
                acc = acc + ap[dy:dy + h, dx:dx + w]
        return acc
    sxx, syy, sxy = boxsum(gx * gx), boxsum(gy * gy), boxsum(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    scale = 1.0 / (4 * block * 255.0)
    return (det - k * tr * tr) * (scale ** 4)


def nms_rank(corner: torch.Tensor, harris: torch.Tensor,
             patch_size: int = 40) -> torch.Tensor:
    """The plane a level's top-k sorts: the Harris response where a FAST
    corner survives 3x3 NMS among corners inside the `patch_size // 2 + 2`
    border, else -inf."""
    lh, lw = harris.shape
    dev = harris.device
    # NMS over candidates only: non-corners must not suppress corners.
    masked = torch.where(corner, harris, -torch.inf)
    pooled = F.max_pool2d(masked[None, None], 3, stride=1, padding=1)[0, 0]
    border = patch_size // 2 + 2
    yy = torch.arange(lh, device=dev)[:, None]
    xx = torch.arange(lw, device=dev)[None, :]
    inb = ((yy >= border) & (yy < lh - border) &
           (xx >= border) & (xx < lw - border))
    cand = corner & (masked >= pooled) & inb
    return torch.where(cand, harris, -torch.inf)



def orb_detect_maps_plain(gray: torch.Tensor, level: int, lh: int, lw: int,
                          patch_size: int = 40, fast_threshold: float = 20.0):
    """`orb_detect_maps` in PyTorch ops."""
    img_l = (resize(gray, (lh, lw)) if level
             else gray.to(torch.float32)).contiguous()
    corner = fast_corner_mask(gray if level == 0 else img_l, fast_threshold)
    harris = harris_response_map(img_l)
    return (img_l,
            gaussian_blur(img_l, BLUR_SIGMA, BLUR_RADIUS).contiguous(),
            harris, nms_rank(corner, harris, patch_size))


def _check(gray, level, lh, lw, patch_size):
    if gray.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"orb_detect_maps: gray must be uint8 or float32, "
                        f"got {gray.dtype}")
    if gray.ndim != 2:
        raise ValueError(f"orb_detect_maps: gray must be (H, W), got "
                         f"{tuple(gray.shape)}")
    if not gray.is_contiguous():
        raise ValueError("orb_detect_maps: gray must be contiguous")
    if level < 0 or min(lh, lw) < BLUR_RADIUS + 1 or patch_size < 0:
        raise ValueError(f"orb_detect_maps: level {level}, plane {lh}x{lw}, "
                         f"patch {patch_size}: need level >= 0, both sides "
                         f"> {BLUR_RADIUS} and patch >= 0")
    if level == 0 and (lh, lw) != tuple(gray.shape):
        raise ValueError(f"orb_detect_maps: level 0 is the image itself, "
                         f"{tuple(gray.shape)}, not {lh}x{lw}")


def orb_detect_maps(gray: torch.Tensor, level: int, lh: int, lw: int,
                    patch_size: int = 40, fast_threshold: float = 20.0):
    """One pyramid level of one (H, W) uint8 or float32 image, in one
    launch.  Returns four (lh, lw) float32 planes: the level plane (the
    image at level 0, else its `resize` to lh x lw), its
    `gaussian_blur(., 2.0, 3)`, its `harris_response_map`, and the rank
    plane `detect_level` sorts: the response where a FAST corner (of the
    image's pixels at level 0, of the rounded plane above) survives 3x3
    NMS among corners inside the `patch_size // 2 + 2` border, else -inf."""
    _check(gray, level, lh, lw, patch_size)
    dev = gray.device
    if dev.type == "cpu":
        return orb_detect_maps_plain(gray, level, lh, lw, patch_size,
                                     fast_threshold)
    if dev.type != "cuda":
        raise ValueError(f"orb_detect_maps: no kernel for device {dev}")
    lib = load_library()
    outs = [torch.empty((lh, lw), dtype=torch.float32, device=dev)
            for _ in range(4)]
    h, w = gray.shape
    consts = (ctypes.c_float * len(KERNEL_CONSTS))(*KERNEL_CONSTS)
    code = lib.orb_detect_maps_launch(
        gray.data_ptr(), int(gray.dtype == torch.uint8), h, w, lh, lw,
        int(level > 0), consts, int(fast_threshold), patch_size // 2 + 2,
        *(t.data_ptr() for t in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "orb_detect_maps")
    orb_detect_maps.launches += 1
    return tuple(outs)


orb_detect_maps.launches = 0
