"""The benchmark's arithmetic: the card's peaks, each kernel's bound from
the shapes of its calls, and the reduction of a torch.profiler trace.

Frozen copies: `bound`, `k4_bound` and `k5_union_bytes` of `chip_smoke.py`
(`:303`, `:714`, `:1675`), with `band_offsets` of
`image_stitching_tpu_torch/kernels/multiband.py`; `device_spans`,
`busy_seconds` and the stage ranges of `tools/profile_torch_stitch.py`
(`_device_spans`, `_busy_ms`, `_stage_lines`).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

# The H100 SXM's published peaks (NVIDIA data sheet, dense): HBM bytes/s,
# float32 outside the tensor cores (also used for 32-bit integer work),
# int8 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12

# Device kernel names of the port's hand kernels.
K4_KERNELS = ("hamming_unpack_kernel", "hamming_wgmma_kernel")
K5_KERNELS = ("pyr_down_batch_kernel", "band_accumulate_batch_kernel")


def bound(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the CUDA-core peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_bound(k: int, words: int, n_valid: Sequence[int],
             ii: Sequence[int], jj: Sequence[int]) -> Dict[str, float]:
    """K4's bound over the distances the data needs (valid rows against
    valid columns, per pair and direction), for an (N, K, W) stack with
    n_valid valid rows per image and pairs (ii[p], jj[p]).  CUDA cores:
    W XOR, W POPC, W - 1 adds and one compare a distance at the float32
    peak; tensor cores: a 32 W-deep int8 dot product, 64 W operations, at
    the int8 dense peak.  Bytes: the packed descriptors and validity in,
    four (2, P, K) outputs of 8 + 4 + 8 + 4 bytes a row out."""
    nv = np.asarray(n_valid, np.float64)
    ii, jj = np.asarray(ii, np.int64), np.asarray(jj, np.int64)
    n_img = len(nv)
    n_dist = float(2 * (nv[ii] * nv[jj]).sum())
    n_bytes = n_img * k * words * 4 + n_img * k + 2 * len(ii) * k * 24
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    cuda_core_ms = max(t_bytes, 3 * words * n_dist / CUDA_CORE_OPS_PER_S *
                       1e3)
    tensor_ms = max(t_bytes, 64 * words * n_dist / INT8_TENSOR_OPS_PER_S *
                    1e3)
    bound_ms = min(cuda_core_ms, tensor_ms)
    return dict(n_dist=n_dist, t_bytes=t_bytes, cuda_core_ms=cuda_core_ms,
                tensor_ms=tensor_ms, bound_ms=bound_ms)


def band_offsets(off: Sequence[int], acc_hw: Sequence[Tuple[int, int]],
                 ph: int, pw: int) -> List[Tuple[int, int]]:
    """(oy, ox) of band b's window: the band-0 offset (x, y) shifted by b,
    clamped so the (ph >> b, pw >> b) window lies inside the accumulator
    of size acc_hw[b]."""
    out = []
    for b, (ah, aw) in enumerate(acc_hw):
        gh, gw = ph >> b, pw >> b
        oy = min(max(off[1] >> b, 0), ah - gh)
        ox = min(max(off[0] >> b, 0), aw - gw)
        out.append((oy, ox))
    return out


def k5_union_bytes(shape: Tuple[int, int, int], offs, acc_hw, nb: int) -> int:
    """Bytes of one K5 call on n rects of (ph, pw) at `offs` into
    accumulators of sizes acc_hw: the rects in, the union of their
    windows in every band read and written once."""
    n, ph, pw = shape
    n_bytes = 16 * n * ph * pw
    for b in range(nb + 1):
        cover = np.zeros(tuple(acc_hw[b]), bool)
        for off in offs:
            oy, ox = band_offsets(off, acc_hw, ph, pw)[b]
            cover[oy:oy + (ph >> b), ox:ox + (pw >> b)] = True
        n_bytes += 2 * 16 * int(cover.sum())
    return n_bytes


def k5_bound_ms(shape, offs, acc_hw, nb: int) -> float:
    return bound(k5_union_bytes(shape, offs, acc_hw, nb), 0.0)[0]


# ---- the profiler trace ------------------------------------------------

def _is_device(e) -> bool:
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def device_spans(events) -> List[Tuple[float, float]]:
    """(start, end) us of the device's work: kernels, copies and sets, not
    the user-annotation ranges the profiler mirrors onto the device."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if _is_device(e))


def merged(spans, lo=float("-inf"), hi=float("inf")):
    """The union of spans clipped to [lo, hi], as disjoint sorted spans."""
    out: List[List[float]] = []
    for s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(spans, lo=float("-inf"), hi=float("inf")) -> float:
    """Union of the device spans clipped to [lo, hi], in seconds."""
    return sum(e - s for s, e in merged(spans, lo, hi)) / 1e6


class TraceSummary:
    """What the per-layer readers take from a profile of `n_stitches`
    stitches between host times lo and hi (us)."""

    def __init__(self, events, n_stitches: int, lo: float, hi: float,
                 stage_names: Sequence[str]):
        import torch
        cpu = torch.autograd.DeviceType.CPU
        self.n_stitches = n_stitches
        self.window_s = (hi - lo) / 1e6
        spans = device_spans(events)
        self.busy_s = busy_seconds(spans, lo, hi)
        self.launches = sum(1 for e in events if e.device_type == cpu
                            and "LaunchKernel" in e.name)
        self.kernel_s: Dict[str, float] = defaultdict(float)
        for e in events:
            if _is_device(e):
                self.kernel_s[e.name] += e.time_range.elapsed_us() / 1e6
        self.stages = sorted((e.time_range.start, e.time_range.end, e.name)
                             for e in events if e.device_type == cpu
                             and e.name in set(stage_names))
        self.gaps = []
        busy = merged(spans, lo, hi)
        edges = [lo] + [t for s in busy for t in s] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                self.gaps.append((self.stage_at(a), (b - a) / 1e6))

    def stage_at(self, t: float) -> str:
        """The stage range the host was in at time t (us)."""
        for s, e, name in self.stages:
            if s <= t < e:
                return name
        return "between stages"

    def kernel_seconds(self, names: Sequence[str]) -> float:
        return sum(v for k, v in self.kernel_s.items()
                   if any(n in k for n in names))

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}
