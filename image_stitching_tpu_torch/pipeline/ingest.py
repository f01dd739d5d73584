"""Fast ingest: probe -> decode plan -> background native decode -> uploads
(port of `image_stitching_tpu/pipeline/ingest.py`).

The reference decodes every capture to full RGB on the host, although its
three scales only ever consume a work-scale gray, a seam-scale RGB and a
compose-scale RGB.  This module decodes what the stages need:

  * when every file is an h2v2 (4:2:0) YCbCr JPEG, one entropy pass per
    file yields the codec's own Y/Cb/Cr planes (1.5 bytes a pixel),
    DCT-scaled when the scales allow; libjpeg's fancy upsample and
    fixed-point colour conversion then run on the device, bit-exact
    (`yuv420_to_rgb_exact`), and the Y plane is the detection gray;
  * otherwise a DCT-scaled RGB stream, plus a luma-only stream when the
    RGB is decoded below work scale;
  * the decode runs on the runtime's background threads (the GIL released),
    one a file up to the CPUs the process may use (`decode_width`), into
    host buffers, pinned on CUDA, and each image's upload is queued as soon
    as its decode is done.

Orientation (portrait 90 degrees clockwise, landscape 180) and the resizes
run on the device, in `fast_prep`.  Every device step is plain integer or
float32 tensor arithmetic, as the reference's plain `jnp` is.  The
runtime is required: `start_fast_ingest` raises when it neither loads nor
builds (`core/native.py`), and returns None only for capture sets the fast
path does not take (PNG or other non-JPEG files, mixed sizes), as the
reference does; the stitcher then takes the legacy decode.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import native
from ..core.logging import count, span
from ..ops.imgproc import resize, rgb_to_gray

__all__ = ["FastIngest", "start_fast_ingest", "fast_prep", "pick_num8",
           "yuv420_to_rgb_exact", "decode_width"]

_JPEG_EXTS = {".jpg", ".jpeg"}
_CPU_MAX = "/sys/fs/cgroup/cpu.max"   # cgroup v2: "<quota|max> <period>"


def decode_width(n_items: int, cpus: int, cpu_max: Optional[str]) -> int:
    """Threads of a background decode of n_items files: one a file, at most
    one a CPU the process may use.  cpus: the size of its affinity set;
    cpu_max: the text of its cgroup's `cpu.max` (None where there is
    none), whose quota over period, rounded up, bounds the CPUs too."""
    width = cpus
    fields = (cpu_max or "").split()
    if len(fields) == 2 and fields[0] != "max":
        width = min(width, math.ceil(int(fields[0]) / int(fields[1])))
    return max(1, min(n_items, width))


def _cpu_limits() -> Tuple[int, Optional[str]]:
    """(CPUs in this process's affinity set, the text of `cpu.max` or
    None): what `decode_width` reads of the host."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:      # no affinity call on this platform
        cpus = os.cpu_count() or 1
    try:
        with open(_CPU_MAX) as f:
            return cpus, f.read()
    except OSError:
        return cpus, None


def pick_num8(scale_needed: float) -> int:
    """Smallest DCT numerator num8 in 1..8 whose decode scale num8/8 still
    covers `scale_needed` (a decoded image is never upsampled)."""
    return max(1, min(8, math.ceil(8.0 * scale_needed - 1e-9)))


def _fancy_upsample2x(c: torch.Tensor) -> torch.Tensor:
    """libjpeg's h2v2 fancy (triangle) chroma upsample, bit-exact, on the
    last two axes of an int32 (..., H, W) plane (the valid ceil(h/2) x
    ceil(w/2) crop).  Returns (..., 2H, 2W) int32: rows 3 * near + far
    (edge rows repeated), then columns (3 * this + other + 8 | 7) >> 4
    with the edges clamped, as jdsample.c h2v2_fancy_upsample."""
    up = torch.cat([c[..., :1, :], c[..., :-1, :]], dim=-2)
    dn = torch.cat([c[..., 1:, :], c[..., -1:, :]], dim=-2)
    h, w = c.shape[-2], c.shape[-1]
    v = torch.stack([3 * c + up, 3 * c + dn], dim=-2).reshape(
        *c.shape[:-2], 2 * h, w)
    lf = torch.cat([v[..., :1], v[..., :-1]], dim=-1)
    rt = torch.cat([v[..., 1:], v[..., -1:]], dim=-1)
    return torch.stack([(3 * v + lf + 8) >> 4, (3 * v + rt + 7) >> 4],
                       dim=-1).reshape(*v.shape[:-1], 2 * w)


def yuv420_to_rgb_exact(y: torch.Tensor, cb: torch.Tensor,
                        cr: torch.Tensor) -> torch.Tensor:
    """JPEG 4:2:0 planes -> RGB u8, bit-exact against libjpeg's own path
    (fancy upsample, then jdcolor.c's fixed point with SCALEBITS 16).

    y: (..., H, W) u8; cb/cr: (..., ceil(H/2), ceil(W/2)) u8.  Returns
    (..., H, W, 3) u8.  Widened to int32 first (u8 would wrap); `>>` on
    int32 is the arithmetic (floor) shift libjpeg's tables assume."""
    h, w = y.shape[-2], y.shape[-1]
    cbf = _fancy_upsample2x(cb.to(torch.int32))[..., :h, :w] - 128
    crf = _fancy_upsample2x(cr.to(torch.int32))[..., :h, :w] - 128
    yi = y.to(torch.int32)
    r = yi + ((91881 * crf + 32768) >> 16)
    b = yi + ((116130 * cbf + 32768) >> 16)
    g = yi + ((-22554 * cbf - 46802 * crf + 32768) >> 16)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255).to(
        torch.uint8)


@dataclasses.dataclass
class FastIngest:
    session: "native.DecodeSession"
    n: int
    want_gray: bool        # a dedicated luma-only decode stream exists
    gray_from_rgb: bool    # the detection gray comes from the RGB stream
    gray_num8: int
    rgb_num8: int
    full_sizes: List[Tuple[int, int]]  # oriented (w, h) per image
    raw_yuv: bool = False  # the stream is packed 4:2:0 planes (flat u8)
    decode_hw: Tuple[int, int] = (0, 0)  # unoriented (h, w) at decode
    raw_num8: int = 8      # DCT scale of the raw 4:2:0 decode
    # Packed-plane layout of the raw decode: (ya_h, ya_w, h_d, w_d), the
    # iMCU-aligned Y strides and the valid (scaled) dims; chroma halves.
    raw_layout: Tuple[int, int, int, int] = (0, 0, 0, 0)
    device: torch.device = torch.device("cuda")
    threads: int = 1       # the decode's width (`decode_width`)

    def upload(self):
        """Wait for the decodes in order, queueing each image's upload
        (non-blocking from pinned memory on CUDA) as soon as it is
        decoded, into one preallocated device stack per stream.  Returns
        (gray_stack | None, rgb_stack), unoriented, at decode scale; rgb
        is (N, L) packed planes on the raw route.  The host buffers stay
        with the session, which this object holds, until the stitch ends;
        the stage's device fence comes first."""
        per = 2 if self.want_gray else 1
        shapes = self.session.shapes
        gray_d = (torch.empty((self.n,) + tuple(shapes[0]), dtype=torch.uint8,
                              device=self.device) if self.want_gray else None)
        rgb_d = torch.empty((self.n,) + tuple(shapes[per - 1]),
                            dtype=torch.uint8, device=self.device)
        async_copy = self.device.type == "cuda"
        for i in range(self.n):
            last = per * (i + 1) - 1     # the RGB item; gray precedes it
            if gray_d is not None:
                self._upload(gray_d[i], last - 1, async_copy)
            self._upload(rgb_d[i], last, async_copy)
        self.session.finish()
        return gray_d, rgb_d

    def _upload(self, dst: torch.Tensor, item: int, async_copy: bool):
        """Wait for item's decode, then queue its copy into dst."""
        with span("decode wait", item=item):
            host = self.session.wait(item)
        dst.copy_(torch.as_tensor(host), non_blocking=async_copy)
        count("ingest.upload_bytes", dst.nbytes)


def start_fast_ingest(paths: Sequence[str], is_portrait: bool,
                      want_gray: bool, gray_scale: float, rgb_scale: float,
                      device="cuda") -> Optional[FastIngest]:
    """Begin the background decode of a uniform all-JPEG capture set, into
    pinned host buffers when `device` is CUDA.

    Raises RuntimeError when the native runtime is missing.  Returns None
    for sets the fast path does not take (a non-JPEG file, a header that
    does not parse, mixed sizes): the caller takes the legacy decode.
    gray_scale / rgb_scale: the smallest scale each stream must cover
    (work scale; max(seam, compose source) scale)."""
    native.load()
    device = torch.device(device)
    sizes = []
    for p in paths:
        if os.path.splitext(p)[1].lower() not in _JPEG_EXTS:
            return None
        wh = native.probe_image(p)
        if wh is None:
            return None
        sizes.append(wh)
    if len(set(sizes)) != 1:
        return None
    w_dec, h_dec = sizes[0]
    full = (h_dec, w_dec) if is_portrait else (w_dec, h_dec)
    gray_num8 = pick_num8(gray_scale) if want_gray else 8
    rgb_num8 = pick_num8(rgb_scale)

    def session(items):
        """The decode session of items and its width."""
        buffers = None
        if device.type == "cuda":
            buffers = [torch.empty(native.item_shape(*it), dtype=torch.uint8,
                                   pin_memory=True) for it in items]
        threads = decode_width(len(items), *_cpu_limits())
        sess = native.DecodeSession(items, nthreads=threads, buffers=buffers)
        count("ingest.decode_threads", threads)
        return sess, threads

    # The raw 4:2:0 route when every file is h2v2 YCbCr: the codec's planes
    # at the largest scale needed, one entropy pass per file for both the
    # detection luma (Y) and the colour.
    use_raw = True
    for p in paths:
        probe = native.probe_jpeg_sampling(p)
        if probe is None or not probe[2]:
            use_raw = False
            break
    if use_raw:
        raw_num8 = max(gray_num8 if want_gray else 1, rgb_num8)
        if raw_num8 % 2 == 1 and raw_num8 < 8:
            raw_num8 += 1   # libjpeg-turbo's even scaled IDCTs are SIMD
        try:
            sess, threads = session([(p, False, raw_num8, True)
                                     for p in paths])
        except OSError:
            return None
        ya_w, ya_h, _, _ = native.yuv420_layout(w_dec, h_dec, raw_num8)
        wd, hd = native.scaled_dims(w_dec, h_dec, raw_num8)
        return FastIngest(session=sess, n=len(paths), want_gray=False,
                          gray_from_rgb=want_gray, gray_num8=raw_num8,
                          rgb_num8=raw_num8, full_sizes=[full] * len(paths),
                          raw_yuv=True, decode_hw=(hd, wd),
                          raw_num8=raw_num8, raw_layout=(ya_h, ya_w, hd, wd),
                          device=device, threads=threads)
    # Derive the detection gray from the RGB stream when that covers work
    # scale (one decode pass); a luma-only stream only when the RGB is
    # DCT-scaled below work scale.
    gray_from_rgb = want_gray and rgb_num8 / 8.0 >= gray_scale - 1e-9
    decode_gray = want_gray and not gray_from_rgb
    items = []
    for p in paths:
        if decode_gray:
            items.append((p, True, gray_num8))
        items.append((p, False, rgb_num8))
    try:
        sess, threads = session(items)
    except OSError:
        return None
    return FastIngest(session=sess, n=len(paths), want_gray=decode_gray,
                      gray_from_rgb=gray_from_rgb, gray_num8=gray_num8,
                      rgb_num8=rgb_num8, full_sizes=[full] * len(paths),
                      decode_hw=(h_dec, w_dec), device=device,
                      threads=threads)


def _orient_stack(x: torch.Tensor, is_portrait: bool) -> torch.Tensor:
    """Batched orient_capture: portrait rotates each image 90 degrees
    clockwise, landscape 180."""
    if is_portrait:
        return torch.flip(x.transpose(1, 2), dims=(2,))
    return torch.flip(x, dims=(1, 2))


def _to_u8(g: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g), 0, 255).to(torch.uint8)


def _unpack_planes(stack: torch.Tensor, layout):
    """(N, L) packed 4:2:0 planes -> the valid Y (N, h, w) and Cb, Cr
    (N, ceil(h/2), ceil(w/2)) crops (views)."""
    ya_h, ya_w, h_d, w_d = layout
    n = stack.shape[0]
    ca_h, ca_w = ya_h // 2, ya_w // 2
    ch, cw = (h_d + 1) // 2, (w_d + 1) // 2
    y_sz, c_sz = ya_w * ya_h, ca_w * ca_h
    y = stack[:, :y_sz].reshape(n, ya_h, ya_w)[:, :h_d, :w_d]
    cb = stack[:, y_sz:y_sz + c_sz].reshape(n, ca_h, ca_w)[:, :ch, :cw]
    cr = stack[:, y_sz + c_sz:y_sz + 2 * c_sz].reshape(
        n, ca_h, ca_w)[:, :ch, :cw]
    return y, cb, cr


def fast_prep(fi: FastIngest, gray_stack, rgb_stack, is_portrait: bool,
              work_hw: Tuple[int, int], seam_hw: Tuple[int, int]):
    """Unpack, convert, orient and resize the decoded stacks on their
    device.  Returns (gray_work (N, Hw, Ww) u8 | None, rgb_oriented (N, H,
    W, 3) u8 at decode scale, seam (N, sh, sw, 3) u8)."""
    work_hw, seam_hw = tuple(work_hw), tuple(seam_hw)
    y_planes = None
    if fi.raw_yuv:
        y_planes, cb, cr = _unpack_planes(rgb_stack, fi.raw_layout)
        rgb_stack = yuv420_to_rgb_exact(y_planes, cb, cr)
    rgb_o = _orient_stack(rgb_stack, is_portrait)
    seam = torch.stack([_to_u8(resize(im, seam_hw)) for im in rgb_o])
    if fi.raw_yuv and fi.gray_from_rgb:
        # The codec Y plane is the BT.601 luma a luma-only decode gives.
        luma = y_planes
    elif fi.want_gray:
        luma = gray_stack
    elif fi.gray_from_rgb:
        return (torch.stack([_to_u8(rgb_to_gray(resize(im, work_hw)))
                             for im in rgb_o]), rgb_o.contiguous(), seam)
    else:
        return None, rgb_o.contiguous(), seam
    g_o = _orient_stack(luma, is_portrait)
    gray_work = (g_o.contiguous() if tuple(g_o.shape[1:3]) == work_hw
                 else torch.stack([_to_u8(resize(g, work_hw)) for g in g_o]))
    return gray_work, rgb_o.contiguous(), seam
