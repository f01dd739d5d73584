"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  0. environment: torch, CUDA, the card's name and power limit, host codec;
     then the captures: an 8-image 2448x3264 spherical ring (55 deg FOV,
     0.5 overlap) rendered with the port's synth and written as JPEGs with
     EXIF pose priors, twice: sigma-4 sensor noise (E2E_RING) for the
     work-scale path, sigma 8 (DEFAULT_RING) for the default path, where
     sigma 4 makes some adjacent pairs near-duplicates by the reference's
     confidence rule (see data/synth.py);
  1. build: the four CUDA kernels compiled with nvcc for sm_90a, one nvcc
     per source, all at once;
  2. K1 (orb_sample) against its plain PyTorch version on the level-0
     plane of the work-scale path (1224x1632) and its keypoint count;
  3. K2 (warp_bilinear) against its plain version on every compose rect
     of a warm-up stitch() of the work-scale path, and grid_sample timed
     beside it;
  4. end to end, the work-scale path: num_features=1500, work_megapix=1.9,
     no exposure compensation, the "no" seam finder; timed after the
     warm-up, held to 8/8 kept, <= 1 px mean pairwise reprojection error
     against the ground truth, mask coverage > 0.9, launches > 0;
  5. K3: K1 on the full-resolution level-0 plane of the default path's
     first capture (2448x3264, 32 MB, past the TPU kernel's 11 MB VMEM
     budget) with phase 2's checks;
  6. K4 (hamming_two_nn) on the descriptors of a warm-up stitch() with the
     reference defaults (4000 ORB features at full resolution, GAIN_BLOCKS
     exposure, DP colour seams; fast ingest off), all 28 pairs in the
     chunks and both directions that matching runs;
  7. K5 (pyramid_accumulate) on every compose rect of that warm-up stitch,
     accumulators within 2e-3, finalized u8 panorama within 1; K2 against
     its plain version on the same rects' samples;
  8. end to end, the default path: timed after the warm-up, held to 8/8
     kept, <= 1 px reprojection, mask coverage > 0.9, finite positive
     gains, seam-mask union equal to the warped-mask union, and launches of
     all four kernels > 0.
Then a JSON line of kernel results (time, plain time, bound, library call
time, launches on the path the kernel was checked on), the nvidia-smi
line, and a last JSON line {"ok": true, "device": {...}}.  Without a CUDA
device it exits non-zero and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from image_stitching_tpu_torch.core.logging import Recorder
from image_stitching_tpu_torch.data.synth import (DEFAULT_RING, E2E_RING,
                                                  write_ring_dir)

N_IMAGES = E2E_RING["n_images"]
H, W = E2E_RING["hw"]

# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and the
# float32 rate outside the tensor cores, the only CUDA-core rate listed
# there, used for the kernels' 32-bit integer and float operations alike.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
TPU_VMEM_BUDGET = 11 * 2 ** 20     # orb_sample_pallas.py:60


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the CUDA-core peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def reproj_err_px(cameras, kept, k_true, rs_true, work_scale: float):
    """Mean pairwise reprojection error (px) of consecutive kept images:
    estimated K_b R_b R_a^T K_a^-1 against the ground truth on an 8x8
    pixel grid (gauge-invariant; bench.py `_reproj_err_px`)."""
    c = cameras.numpy()
    kc = np.zeros((len(kept), 3, 3))
    kc[:, 0, 0] = c["focal"]
    kc[:, 0, 2] = c["ppx"]
    kc[:, 1, 1] = c["focal"] * c["aspect"]
    kc[:, 1, 2] = c["ppy"]
    kc[:, 2, 2] = 1.0
    kc[:, :2, :] /= work_scale
    rc = np.asarray(c["R"], np.float64)
    gy, gx = np.meshgrid(np.linspace(0, H - 1, 8), np.linspace(0, W - 1, 8))
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], axis=0)

    def proj(m):
        q = m @ pts
        return q[:2] / np.where(np.abs(q[2:]) < 1e-12, 1e-12, q[2:])
    errs = []
    for a in range(len(kept) - 1):
        b = a + 1
        h_est = kc[b] @ rc[b].T @ rc[a] @ np.linalg.inv(kc[a])
        h_gt = (k_true @ rs_true[kept[b]].T @ rs_true[kept[a]]
                @ np.linalg.inv(k_true))
        errs.append(np.linalg.norm(proj(h_est) - proj(h_gt), axis=0).mean())
    return float(np.mean(errs))


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_k1(dev, gray, n_features: int, phase: str, name: str,
             replaces: str):
    """K1 on a main-path level-0 plane (gray, its sigma-2 blur) and the
    keypoints the detector gives it there."""
    from image_stitching_tpu_torch.kernels.orb_sample import (
        orb_sample, orb_sample_plain, N_SAMPLES)
    from image_stitching_tpu_torch.ops.features.orb import (
        detect_level, pattern_xy, per_level_counts, resolve_pattern)
    from image_stitching_tpu_torch.ops.imgproc import gaussian_blur
    k_l = per_level_counts(n_features, 8, 1.2)[0]
    xy, _, valid = detect_level(gray, gray, k_l)
    blur = gaussian_blur(gray, 2.0, 3)
    pat = pattern_xy(resolve_pattern(None), dev)
    s_k, a_k, m_k, d_k = orb_sample(gray, blur, xy, pat, 20)
    s_p, a_p, m_p, d_p = orb_sample_plain(gray, blur, xy, pat, 20)
    torch.cuda.synchronize()
    # Moments: |dm| <= 1e-5 of the sum of |v * d| over the disk (the scale
    # of float32 summation error, where a relative error of the cancelled
    # sum itself is not).
    ys, xs = np.mgrid[-20:21, -20:21]
    disk = (xs * xs + ys * ys) <= 400
    h, w = gray.shape
    cx = torch.round(xy[:, 0]).long().clamp(0, w - 1)
    cy = torch.round(xy[:, 1]).long().clamp(0, h - 1)
    dys = torch.as_tensor(ys[disk], device=dev)
    dxs = torch.as_tensor(xs[disk], device=dev)
    rows = (cy[:, None] + dys).clamp(0, h - 1)
    cols = (cx[:, None] + dxs).clamp(0, w - 1)
    vals = gray[rows, cols]
    mag = torch.stack([(vals * dxs.abs()).sum(1), (vals * dys.abs()).sum(1)],
                      -1)
    mom_rel = float(((m_k - m_p).abs() / mag.clamp(min=1.0)).max())
    assert mom_rel <= 1e-5, f"K1 moments differ: {mom_rel:.3g} of magnitude"
    # Samples must be equal wherever the rounded coordinates agree.
    def coords(ang):
        ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        gx = torch.round(xy[:, 0:1] + (ca * pat[0] - sa * pat[1]))
        gy = torch.round(xy[:, 1:2] + (sa * pat[0] + ca * pat[1]))
        return gx.clamp(0, w - 1).long(), gy.clamp(0, h - 1).long()
    gxk, gyk = coords(a_k)
    gxp, gyp = coords(a_p)
    agree = (gxk == gxp) & (gyk == gyp)
    bad = int(((s_k != s_p) & agree).sum())
    assert bad == 0, f"K1 samples differ at {bad} agreeing coordinates"
    bits_k = ((d_k[..., None] >> torch.arange(32, device=dev)) & 1)
    bits_p = ((d_p[..., None] >> torch.arange(32, device=dev)) & 1)
    flips = int((bits_k != bits_p).sum())
    n_bits = bits_k.numel()
    assert flips <= 1e-4 * n_bits, f"K1 descriptor bits flipped: {flips}"
    ms = time_ms(lambda: orb_sample(gray, blur, xy, pat, 20))
    plain_ms = time_ms(lambda: orb_sample_plain(gray, blur, xy, pat, 20))
    max_err = float((s_k - s_p).abs().max())
    # Bytes: the pixels this run's keypoints need, each read once (the
    # union of their disks in the raw plane and of their rounded sample
    # coordinates in the blurred plane), keypoints and pattern in; samples,
    # moments and descriptors out.  Operations: per keypoint the disk's two
    # moment sums, the 512 rotations and rounds, 256 compares.
    plane = gray.numel() * 4
    disk_px = int(torch.unique(rows * w + cols).numel())
    sample_px = int(torch.unique(gyk * w + gxk).numel())
    n_bytes = 4 * (disk_px + sample_px) + xy.numel() * 4 + \
        pat.numel() * 4 + k_l * (N_SAMPLES * 4 + 8 + 32)
    n_ops = k_l * (int(disk.sum()) * 4 + N_SAMPLES * 8 + 256)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"phase {phase} K1 orb_sample: plane {tuple(gray.shape)} "
          f"({plane} bytes, {plane / TPU_VMEM_BUDGET:.2f}x the TPU kernel's "
          f"{TPU_VMEM_BUDGET}-byte VMEM budget) K={k_l} (valid "
          f"{int(valid.sum())}), moments max |dm|/magnitude {mom_rel:.3g} "
          f"(tol 1e-5), samples {N_SAMPLES} per keypoint unequal at agreeing "
          f"coords {bad}, coords disagreeing {int((~agree).sum())}, bit "
          f"flips {flips}/{n_bits} (tol 1e-4), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{disk_px} disk and {sample_px} sample pixels read, "
          f"{n_bytes} bytes in all)",
          flush=True)
    return dict(name=name, route="cuda",
                source="image_stitching_tpu_torch/csrc/orb_sample.cu",
                replaces=replaces, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def k2_max_diff(calls) -> float:
    """Largest |K2 - plain| over (src, sx, sy) calls."""
    from image_stitching_tpu_torch.kernels.warp_gather import (
        warp_bilinear, warp_bilinear_plain)
    err = 0.0
    for src, sx, sy in calls:
        out_k = warp_bilinear(src, sx, sy)
        out_p = warp_bilinear_plain(src, sx, sy)
        torch.cuda.synchronize()
        err = max(err, float((out_k - out_p).abs().max()))
    assert err <= 1e-4, f"K2 differs from its plain version by {err}"
    return err


def check_k2(dev, paths, cfg, res):
    """K2 on the (img, sx, sy) that each compose rect of a main-path stitch
    gives it: that stitch's cameras through the compose's own geometry
    (`compose_inputs`, `compose_rects`, `rect_grid`, `backward_xy_1d`)."""
    from image_stitching_tpu_torch.core import image_io
    from image_stitching_tpu_torch.kernels.warp_gather import (
        warp_bilinear, warp_bilinear_plain)
    from image_stitching_tpu_torch.ops.imgproc import resize
    from image_stitching_tpu_torch.ops.warps import backward_xy_1d
    from image_stitching_tpu_torch.pipeline.compose_fused import (
        compose_rects, rect_grid)
    from image_stitching_tpu_torch.pipeline.stitcher import compose_inputs
    comp = compose_inputs(res.cameras, (H, W), res.work_scale,
                          cfg.compose_megapix, cfg.warp_type)
    g = compose_rects(comp.corners, comp.sizes, cfg.blend_type,
                      cfg.blend_strength)
    calls = []
    for (bh, bw), idxs in sorted(g.buckets.items()):
        for i in idxs:
            im = torch.from_numpy(image_io.orient_capture(image_io.imread(
                paths[res.kept_indices[i]]), False)).to(dev)
            if comp.resize_hw is not None:
                im = resize(im, comp.resize_hw)
            us, vs = rect_grid(g.tls[i], bh, bw, dev)
            sx, sy, _ = backward_xy_1d(
                us, vs, torch.as_tensor(comp.ks[i], device=dev),
                torch.as_tensor(comp.rs[i], device=dev), comp.warper.scale)
            calls.append((im.to(torch.float32).contiguous(), sx.contiguous(),
                          sy.contiguous()))
    err = k2_max_diff(calls)

    def run(fn):
        for src, sx, sy in calls:
            fn(src, sx, sy)
    ms = time_ms(lambda: run(warp_bilinear)) / len(calls)
    plain_ms = time_ms(lambda: run(warp_bilinear_plain)) / len(calls)
    # Yardstick, never called by the port: one grid_sample per rect on the
    # same samples (planar source, normalised grid, made beforehand).  Its
    # reflection pads about the edge pixels' centres, K2 about their edges.
    lib_in = []
    for src, sx, sy in calls:
        hc, wc = src.shape[0], src.shape[1]
        grid = torch.stack([sx / (wc - 1) * 2 - 1, sy / (hc - 1) * 2 - 1],
                           -1)[None]
        lib_in.append((src.permute(2, 0, 1)[None].contiguous(), grid))
    library_ms = time_ms(lambda: [torch.nn.functional.grid_sample(
        x, grd, mode="bilinear", padding_mode="reflection",
        align_corners=True) for x, grd in lib_in]) / len(calls)
    n_bytes = sum(src.numel() * 4 + sx.numel() * 4 * (2 + 3)
                  for src, sx, _ in calls) / len(calls)
    n_ops = sum(sx.numel() * (3 * 8 + 20) for _, sx, _ in calls) / len(calls)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"phase 3 K2 warp_bilinear: {len(calls)} compose rects of the "
          f"main path, canvas {g.canvas} ({g.canvas_h}x{g.canvas_w} padded, "
          f"{g.n_bands} bands), source {tuple(calls[0][0].shape)} -> rects "
          f"{sorted((3,) + k for k in g.buckets)}, max |diff| {err:.3g} "
          f"(atol 1e-4), per call: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(name="warp_bilinear", route="cuda",
                source="image_stitching_tpu_torch/csrc/warp_gather.cu",
                replaces=("image_stitching_tpu/kernels/"
                          "warp_gather_pallas.py:89"),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_k4(dev, feats):
    """K4 on the descriptors the default path's orb_detect_stack gave
    matching: every pair i < j in match_all_pairs' chunks, (a, b) then
    (b, a), as match_pairs calls it."""
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn, hamming_two_nn_plain)
    from image_stitching_tpu_torch.ops.matching import _pair_chunk
    n, k = feats.xy.shape[0], feats.xy.shape[1]
    iu, ju = np.triu_indices(n, 1)
    chunk = _pair_chunk(k)
    calls = []
    for s in range(0, len(iu), chunk):
        fa = feats[torch.as_tensor(iu[s:s + chunk], device=dev)]
        fb = feats[torch.as_tensor(ju[s:s + chunk], device=dev)]
        calls += [(fa.desc, fb.desc, fb.valid, fa.valid),
                  (fb.desc, fa.desc, fa.valid, fb.valid)]
    big = float(2 ** 30)
    n_rows = 0
    for desc_a, desc_b, valid_b, _ in calls:
        got = hamming_two_nn(desc_a, desc_b, valid_b)
        want = hamming_two_nn_plain(desc_a, desc_b, valid_b)
        torch.cuda.synchronize()
        for m in (0, 1, 3):
            assert torch.equal(got[m], want[m]), \
                f"K4 output {m} differs from its plain version"
        real = want[3] < big
        assert torch.equal(got[2][real], want[2][real]), "K4 i2 differs"
        n_rows += desc_a.shape[0] * desc_a.shape[1]

    def run(fn):
        for desc_a, desc_b, valid_b, _ in calls:
            fn(desc_a, desc_b, valid_b)
    ms = time_ms(lambda: run(hamming_two_nn)) / len(calls)
    plain_ms = time_ms(lambda: run(hamming_two_nn_plain), reps=5) / len(calls)
    # Operations: per valid (row, column) pair 8 XOR, 8 POPC, 7 adds and
    # one compare; bytes: both descriptor sets and the validity in, four
    # (P, Ka) outputs of 8 + 4 + 8 + 4 bytes a row out.
    n_ops = sum(24.0 * float((va.sum(-1) * vb.sum(-1)).sum())
                for _, _, vb, va in calls) / len(calls)
    n_bytes = sum(a.numel() * 4 + b.numel() * 4 + vb.numel() +
                  a.shape[0] * a.shape[1] * 24
                  for a, b, vb, _ in calls) / len(calls)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"phase 6 K4 hamming_two_nn: {len(iu)} pairs of K={k} in "
          f"{len(calls)} launches of P={chunk} (both directions), rows "
          f"{n_rows}, valid per image {feats.valid.sum(-1).tolist()}, i1/d1/"
          f"d2 equal and i2 equal where d2 < 2^30: yes, per launch: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    return dict(name="hamming_two_nn", route="cuda",
                source="image_stitching_tpu_torch/csrc/hamming.cu",
                replaces="image_stitching_tpu/kernels/hamming_pallas.py:178",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_k5(dev, compose_call):
    """K5 on the (warped, weight, offset) of every compose rect of a
    default-path stitch: compose_samples (the compose's own per-rect
    sample) on the arguments that stitch handed fused_compose.  K2 is held
    against its plain version on the (src, sx, sy) of the same samples."""
    from image_stitching_tpu_torch.kernels.multiband import (
        pyramid_accumulate, pyramid_accumulate_plain)
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    args = compose_call[0]
    g = cf.compose_rects(args[4], args[5], args[10], args[11])
    with Recorder(cf, "warp_bilinear") as k2_rec:
        rects = list(cf.compose_samples(*args[:10], g))
    k2_calls = [call[0] for call in k2_rec.calls["warp_bilinear"]]
    k2_err = k2_max_diff(k2_calls)
    nb = g.n_bands

    def fresh():
        return [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b),
                            device=dev) for b in range(nb + 1)]
    acc_k, acc_p = fresh(), fresh()
    for warped, weight, off in rects:
        pyramid_accumulate(warped, weight, off, acc_k, nb)
        pyramid_accumulate_plain(warped, weight, off, acc_p, nb)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(acc_k, acc_p))
    assert err <= 2e-3, f"K5 accumulators differ by {err} (tol 2e-3)"
    pano_k, mask_k = cf._finalize(acc_k, nb)
    pano_p, mask_p = cf._finalize(acc_p, nb)
    u8 = int((pano_k.int() - pano_p.int()).abs().max())
    assert u8 <= 1, f"K5 finalized panorama differs by {u8} (tol 1)"
    assert torch.equal(mask_k, mask_p), "K5 finalized masks differ"
    scratch = fresh()

    def run(fn):
        for warped, weight, off in rects:
            fn(warped, weight, off, scratch, nb)
    ms = time_ms(lambda: run(pyramid_accumulate)) / len(rects)
    plain_ms = time_ms(lambda: run(pyramid_accumulate_plain)) / len(rects)
    # Bytes: the rect (3 planes + weight) in, every band's 4-channel
    # accumulator window read and written.  Operations: 5x5 taps of the
    # 4-channel pyrDown per level, 3x3 nonzero pyrUp taps of 3 channels,
    # subtract, weight and add per band pixel.
    n_bytes = n_ops = 0.0
    for _, weight, _ in rects:
        ph, pw = weight.shape
        n_bytes += 16 * ph * pw + sum(2 * 16 * (ph >> b) * (pw >> b)
                                      for b in range(nb + 1))
        n_ops += sum(4 * 50 * (ph >> b) * (pw >> b)
                     for b in range(1, nb + 1)) + \
            sum((3 * 18 + 12) * (ph >> b) * (pw >> b) for b in range(nb + 1))
    bound_ms, bound_by = bound(n_bytes / len(rects), n_ops / len(rects))
    print(f"phase 7 K5 pyramid_accumulate: {len(rects)} compose rects of the "
          f"default path, canvas {g.canvas} ({g.canvas_h}x{g.canvas_w} "
          f"padded, {nb} bands), rects {sorted((3,) + k for k in g.buckets)}"
          f", gains {type(args[9]).__name__ if args[9] else None}, "
          f"accumulators max |diff| {err:.3g} (tol 2e-3), finalized u8 max "
          f"|diff| {u8} (tol 1), per rect: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); K2 on "
          f"the same {len(k2_calls)} rects' samples, source "
          f"{tuple(k2_calls[0][0].shape)}: max |diff| {k2_err:.3g} "
          f"(atol 1e-4)", flush=True)
    return dict(name="pyramid_accumulate", route="cuda",
                source="image_stitching_tpu_torch/csrc/multiband.cu",
                replaces="image_stitching_tpu/kernels/multiband_pallas.py:177",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def seam_union_gate(seams_call):
    """The union of the seam masks equals the union of the warped masks,
    pixel for pixel, on the seam-scale canvas with u folded modulo the
    ring's period (cross-dateline pairs are seamed a period apart)."""
    args, kwargs, seam_masks = seams_call
    corners, masks_warped = args[0], args[1]
    period = kwargs.get("period")

    def union(masks):
        keys = []
        for (x0, y0), m in zip(corners, masks):
            ys, xs = np.nonzero(np.asarray(m) > 0)
            xs = xs + x0
            if period:
                xs = np.mod(xs, period)
            keys.append((ys.astype(np.int64) + y0) * (1 << 32) + xs)
        return np.unique(np.concatenate(keys))
    want, got = union(masks_warped), union(seam_masks)
    assert np.array_equal(want, got), \
        f"seam masks cover {got.size} px, the warped masks {want.size}"
    cut = sum(int(((np.asarray(a) > 0) & (np.asarray(b) == 0)).sum())
              for a, b in zip(masks_warped, seam_masks))
    return want.size, cut


def stitch_run(stitch, caps, cfg, counters, recorder=None):
    """One timed stitch() with every kernel's count set to 0 just before
    it and read just after."""
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if recorder is None:
        res = stitch(caps, cfg, output="", device="cuda")
    else:
        with recorder:
            res = stitch(caps, cfg, output="", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {fn.__name__: fn.launches for fn in counters}


def e2e_gates(res, k_true, rs_true, launches, names):
    pano = res.panorama
    assert pano.ndim == 3 and pano.shape[2] == 3, tuple(pano.shape)
    assert bool(torch.isfinite(pano).all()), "non-finite panorama"
    assert res.kept_indices == list(range(N_IMAGES)), res.kept_indices
    err = reproj_err_px(res.cameras, res.kept_indices, k_true, rs_true,
                        res.work_scale)
    assert err <= 1.0, f"reprojection error {err:.4f} px > 1 px"
    coverage = float(res.mask.float().mean())
    assert coverage > 0.9, f"mask coverage {coverage:.4f}"
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    stages = ", ".join(f"{k}={v:.4f}s" for k, v in res.stage_times.items())
    return err, coverage, stages


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.core import image_io
    from image_stitching_tpu_torch.kernels import _build
    from image_stitching_tpu_torch.kernels.hamming import hamming_two_nn
    from image_stitching_tpu_torch.kernels.multiband import pyramid_accumulate
    from image_stitching_tpu_torch.kernels.orb_sample import orb_sample
    from image_stitching_tpu_torch.kernels.warp_gather import warp_bilinear
    from image_stitching_tpu_torch.ops.imgproc import resize, rgb_to_gray
    from image_stitching_tpu_torch.pipeline import stitcher
    from image_stitching_tpu_torch.pipeline.stitcher import stitch

    dev = torch.device("cuda")
    smi = _smi()
    print(f"phase 0 env: torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, nvidia-smi '{smi}', host codec "
          f"{image_io.codec_name()}", flush=True)
    counters = (orb_sample, warp_bilinear, hamming_two_nn, pyramid_accumulate)
    names = [fn.__name__ for fn in counters]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        caps = os.path.join(work, "caps")
        caps_default = os.path.join(work, "caps_default")
        t0 = time.perf_counter()
        k_true, rs_true = write_ring_dir(caps, **E2E_RING)
        write_ring_dir(caps_default, **DEFAULT_RING)
        print(f"phase 0 captures: 2 rings of {N_IMAGES} x {H}x{W} (noise "
              f"sigma 4 and {DEFAULT_RING['noise_sigma']}) rendered and "
              f"written in {time.perf_counter() - t0:.3f} s", flush=True)

        _build.load_library()
        print(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
              f"{_build.build_seconds():.3f} s", flush=True)

        paths = image_io.list_images(caps)
        img0 = torch.from_numpy(image_io.orient_capture(
            image_io.imread(paths[0]), False)).to(dev)
        k1 = check_k1(dev, rgb_to_gray(resize(img0, (H // 2, W // 2))), 1500,
                      "2", "orb_sample",
                      "image_stitching_tpu/kernels/orb_sample_pallas.py:145")

        # The work-scale path: half-resolution ORB, no exposure, no seams.
        cfg = StitchConfig(num_features=1500, work_megapix=1.9,
                           expos_comp_type="no", seam_find_type="no",
                           fast_ingest=False, checkpoint_dir=work)
        # The warm-up stitch also gives phase 3 its cameras.
        warm = stitch(caps, cfg, output="", device="cuda")
        k2 = check_k2(dev, paths, cfg, warm)
        res, wall, launches = stitch_run(stitch, caps, cfg, counters)
        err, coverage, stages = e2e_gates(res, k_true, rs_true, launches,
                                          names)
        print(f"phase 4 e2e work-scale path: kept {len(res.kept_indices)}/"
              f"{N_IMAGES}, reprojection {err:.4f} px, panorama "
              f"{tuple(res.panorama.shape)}, mask {coverage:.4f}, launches "
              f"{launches}, wall {wall:.4f} s "
              f"({N_IMAGES * H * W / 1e6 / wall:.3f} MP/s), stages: "
              f"{stages}; card '{smi}'", flush=True)
        k1["launches"] = launches["orb_sample"]
        k2["launches"] = launches["warp_bilinear"]
        del warm, res

        # K3: K1 on the default path's full-resolution level-0 plane.
        img0 = torch.from_numpy(image_io.orient_capture(image_io.imread(
            image_io.list_images(caps_default)[0]), False)).to(dev)
        k3 = check_k1(dev, rgb_to_gray(img0.to(torch.float32)), 4000, "5",
                      f"orb_sample [K3: level 0 at {H}x{W}]",
                      "image_stitching_tpu/kernels/orb_stream_pallas.py:143")

        # The default path: the reference defaults but fast ingest.
        cfg = StitchConfig(fast_ingest=False, checkpoint_dir=work)
        rec = Recorder(stitcher, "match_all_pairs", "fused_compose")
        with rec:
            warm = stitch(caps_default, cfg, output="", device="cuda")
        k4 = check_k4(dev, rec.calls["match_all_pairs"][0][0][0])
        k5 = check_k5(dev, rec.calls["fused_compose"][0])
        del warm, rec
        rec = Recorder(stitcher, "match_all_pairs", "find_seams",
                       "fused_compose")
        res, wall, launches = stitch_run(stitch, caps_default, cfg, counters,
                                         rec)
        err, coverage, stages = e2e_gates(res, k_true, rs_true, launches,
                                          names)
        comp = rec.calls["fused_compose"][0][0][9]
        for i, (gh, gw) in enumerate(comp.grid_sizes):
            gains = comp.gains[i, :gh, :gw]
            assert np.all(np.isfinite(gains)) and np.all(gains > 0), \
                f"image {i}: gains not finite and positive"
        covered, cut = seam_union_gate(rec.calls["find_seams"][0])
        graph = rec.calls["match_all_pairs"][0][2]
        raw = [round(float(graph.num_inliers[a, a + 1] / (
            8.0 + 0.3 * graph.num_matches[a, a + 1])), 4)
            for a in range(N_IMAGES - 1)]
        print(f"phase 8 e2e default path: kept {len(res.kept_indices)}/"
              f"{N_IMAGES}, work scale {res.work_scale}, reprojection "
              f"{err:.4f} px, panorama {tuple(res.panorama.shape)}, mask "
              f"{coverage:.4f}, gains {comp.gains.shape} in "
              f"[{float(comp.gains[comp.gains > 0].min()):.4f}, "
              f"{float(comp.gains.max()):.4f}], seam union = warped union "
              f"({covered} px, {cut} px cut by the seams), adjacent pairs' "
              f"n_inliers / (8 + 0.3 n_matches) {raw} (> 3 is zeroed), "
              f"launches "
              f"{launches}, wall {wall:.4f} s "
              f"({N_IMAGES * H * W / 1e6 / wall:.3f} MP/s), stages: "
              f"{stages}; card '{smi}'", flush=True)
        k3["launches"] = launches["orb_sample"]
        k4["launches"] = launches["hamming_two_nn"]
        k5["launches"] = launches["pyramid_accumulate"]

    print(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
