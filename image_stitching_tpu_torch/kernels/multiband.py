"""K5: multiband pyramid accumulate of one compose rect.

Hopper replacement for `image_stitching_tpu/kernels/multiband_pallas.py`
(`pyramid_accumulate`, `:177`, body `_kernel` `:93`).  The CUDA kernel is
`csrc/multiband.cu`; `pyramid_accumulate_plain` is the reference's live
path, the scan body of `_accumulate_impl` (`pipeline/compose_fused.py:
428-451`): Gaussian levels by the dense banded pyrDown matrices, Laplacian
bands against pyrUp, and an in-place add into each band's accumulator at
the band offset, clamped like `lax.dynamic_slice` clamps its start.

The accumulators are the port's per-band (4, Hb, Wb) float32 planes, the
weight in channel 3; the TPU kernel splits the same state into (3, Hb, Wb)
`accs` and (Hb, Wb) `waccs`.  One call accumulates one image; calls on
one stream are ordered, which keeps overlapping rects' read-modify-writes
in image order as the TPU kernel's sequential grid did.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..ops.pyr_mat import pyr_down_mm, pyr_up_mm
from ._build import check_launch, load_library

__all__ = ["pyramid_accumulate", "pyramid_accumulate_plain", "band_offsets"]


def band_offsets(off: Sequence[int], accs: Sequence[torch.Tensor],
                 ph: int, pw: int) -> List[Tuple[int, int]]:
    """(oy, ox) of band b's window: the band-0 offset (x, y) shifted by b,
    clamped so the (ph >> b, pw >> b) window lies inside the accumulator."""
    out = []
    for b, acc in enumerate(accs):
        gh, gw = ph >> b, pw >> b
        oy = min(max(off[1] >> b, 0), acc.shape[1] - gh)
        ox = min(max(off[0] >> b, 0), acc.shape[2] - gw)
        out.append((oy, ox))
    return out


def pyramid_accumulate_plain(warped: torch.Tensor, weight: torch.Tensor,
                             off: Sequence[int], accs: List[torch.Tensor],
                             n_bands: int) -> None:
    """The reference's scan body in PyTorch ops; updates `accs` in place."""
    gauss = [torch.cat([warped, weight[None]], dim=0)]
    for _ in range(n_bands):
        gauss.append(pyr_down_mm(gauss[-1]))
    offs = band_offsets(off, accs, warped.shape[1], warped.shape[2])
    for b in range(n_bands + 1):
        g = gauss[b]
        lap = (g - pyr_up_mm(gauss[b + 1], g.shape[1:])
               if b < n_bands else g)
        w = g[3:4]
        val = torch.cat([lap[:3] * w, w], dim=0)
        gh, gw = g.shape[1], g.shape[2]
        oy, ox = offs[b]
        accs[b][:, oy:oy + gh, ox:ox + gw] += val


def _check(warped, weight, accs, n_bands):
    dev = warped.device
    for name, t in [("warped", warped), ("weight", weight)] + [
            (f"accs[{b}]", a) for b, a in enumerate(accs)]:
        if t.dtype != torch.float32:
            raise TypeError(f"pyramid_accumulate: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"pyramid_accumulate: {name} on {t.device}, "
                             f"warped on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"pyramid_accumulate: {name} must be "
                             "contiguous")
    if warped.ndim != 3 or warped.shape[0] != 3:
        raise ValueError(f"pyramid_accumulate: warped must be (3, ph, pw), "
                         f"got {tuple(warped.shape)}")
    ph, pw = warped.shape[1], warped.shape[2]
    if tuple(weight.shape) != (ph, pw):
        raise ValueError(f"pyramid_accumulate: weight must be ({ph}, {pw}), "
                         f"got {tuple(weight.shape)}")
    step = 1 << n_bands
    if ph % step or pw % step:
        raise ValueError(f"pyramid_accumulate: rect {ph}x{pw} is not a "
                         f"multiple of 2^{n_bands}")
    if len(accs) != n_bands + 1:
        raise ValueError(f"pyramid_accumulate: {len(accs)} accumulators for "
                         f"{n_bands} bands")
    for b, a in enumerate(accs):
        if a.ndim != 3 or a.shape[0] != 4 or a.shape[1] < ph >> b or \
                a.shape[2] < pw >> b:
            raise ValueError(f"pyramid_accumulate: accs[{b}] "
                             f"{tuple(a.shape)} cannot hold a "
                             f"{ph >> b}x{pw >> b} window")


def pyramid_accumulate(warped: torch.Tensor, weight: torch.Tensor,
                       off: Sequence[int], accs: List[torch.Tensor],
                       n_bands: int) -> None:
    """Accumulate one image's weighted Laplacian bands into `accs` in
    place.  warped (3, ph, pw) planar float32, weight (ph, pw), off the
    band-0 canvas offset (x, y) as host ints, accs the n_bands + 1 band
    accumulators (4, Hb, Wb).  ph and pw are multiples of 2^n_bands."""
    _check(warped, weight, accs, n_bands)
    dev = warped.device
    if dev.type == "cpu":
        pyramid_accumulate_plain(warped, weight, off, accs, n_bands)
        return
    if dev.type != "cuda":
        raise ValueError(f"pyramid_accumulate: no kernel for device {dev}")
    lib = load_library()
    ph, pw = warped.shape[1], warped.shape[2]
    scratch = torch.empty(
        (max(1, sum(4 * (ph >> b) * (pw >> b)
                    for b in range(1, n_bands + 1))),),
        dtype=torch.float32, device=dev)
    offs = band_offsets(off, accs, ph, pw)
    acc_ptrs = (ctypes.c_void_p * len(accs))(*[a.data_ptr() for a in accs])
    acc_hw = (ctypes.c_int * (2 * len(accs)))(
        *[d for a in accs for d in (a.shape[1], a.shape[2])])
    offs_c = (ctypes.c_int * (2 * len(accs)))(*[v for o in offs for v in o])
    code = lib.pyramid_accumulate_launch(
        warped.data_ptr(), weight.data_ptr(), scratch.data_ptr(), ph, pw,
        n_bands, acc_ptrs, acc_hw, offs_c,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "pyramid_accumulate")
    pyramid_accumulate.launches += 1


pyramid_accumulate.launches = 0
