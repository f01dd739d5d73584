"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  0. environment: torch, CUDA, the card's name and power limit, host codec;
     then the captures: an 8-image 2448x3264 spherical ring (55 deg FOV,
     0.5 overlap) rendered with the port's synth and written as JPEGs with
     EXIF pose priors;
  1. build: both CUDA kernels compiled with nvcc for sm_90a;
  2. K1 (orb_sample) against its plain PyTorch version on the level-0
     plane of the main path (1224x1632) and its keypoint count;
  3. K2 (warp_bilinear) against its plain version on every compose rect
     of a warm-up stitch() of the ring: its sources and backward maps;
  4. end to end: stitch() of the ring on the card, timed after the warm-up,
     held to 8/8 kept, <= 1 px mean pairwise reprojection error against
     the ground truth, mask coverage > 0.9, and kernel launches > 0.
Then a JSON line of kernel results, the nvidia-smi line, and a last JSON
line {"ok": true, "device": {...}}.  Without a CUDA device it exits
non-zero and prints no result.  Imports nothing of JAX.
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

from image_stitching_tpu_torch.data.synth import E2E_RING, write_ring_dir

N_IMAGES = E2E_RING["n_images"]
H, W = E2E_RING["hw"]


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


def check_k1(dev, img0):
    """K1 on the main path's level-0 plane and keypoints."""
    from image_stitching_tpu_torch.kernels.orb_sample import (
        orb_sample, orb_sample_plain, N_SAMPLES)
    from image_stitching_tpu_torch.ops.features.orb import (
        detect_level, pattern_xy, per_level_counts, resolve_pattern)
    from image_stitching_tpu_torch.ops.imgproc import (gaussian_blur, resize,
                                                       rgb_to_gray)
    gray = rgb_to_gray(resize(img0, (H // 2, W // 2)))
    k_l = per_level_counts(1500, 8, 1.2)[0]
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
    cx = torch.round(xy[:, 0]).long().clamp(0, gray.shape[1] - 1)
    cy = torch.round(xy[:, 1]).long().clamp(0, gray.shape[0] - 1)
    dys = torch.as_tensor(ys[disk], device=dev)
    dxs = torch.as_tensor(xs[disk], device=dev)
    vals = gray[(cy[:, None] + dys).clamp(0, gray.shape[0] - 1),
                (cx[:, None] + dxs).clamp(0, gray.shape[1] - 1)]
    mag = torch.stack([(vals * dxs.abs()).sum(1), (vals * dys.abs()).sum(1)],
                      -1)
    mom_rel = float(((m_k - m_p).abs() / mag.clamp(min=1.0)).max())
    assert mom_rel <= 1e-5, f"K1 moments differ: {mom_rel:.3g} of magnitude"
    # Samples must be equal wherever the rounded coordinates agree.
    def coords(ang):
        ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        gx = torch.round(xy[:, 0:1] + (ca * pat[0] - sa * pat[1]))
        gy = torch.round(xy[:, 1:2] + (sa * pat[0] + ca * pat[1]))
        return gx.clamp(0, gray.shape[1] - 1), gy.clamp(0, gray.shape[0] - 1)
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
    print(f"phase 2 K1 orb_sample: plane {tuple(gray.shape)} K={k_l} "
          f"(valid {int(valid.sum())}), moments max |dm|/magnitude "
          f"{mom_rel:.3g} (tol 1e-5), samples {N_SAMPLES} per keypoint "
          f"unequal at agreeing coords {bad}, coords disagreeing "
          f"{int((~agree).sum())}, bit flips {flips}/{n_bits} (tol 1e-4), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return dict(name="orb_sample", route="cuda",
                source="image_stitching_tpu_torch/csrc/orb_sample.cu",
                replaces=("image_stitching_tpu/kernels/"
                          "orb_sample_pallas.py:145"),
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


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
    err = 0.0
    for src, sx, sy in calls:
        out_k = warp_bilinear(src, sx, sy)
        out_p = warp_bilinear_plain(src, sx, sy)
        torch.cuda.synchronize()
        err = max(err, float((out_k - out_p).abs().max()))
    assert err <= 1e-4, f"K2 differs from its plain version by {err}"

    def run(fn):
        for src, sx, sy in calls:
            fn(src, sx, sy)
    ms = time_ms(lambda: run(warp_bilinear)) / len(calls)
    plain_ms = time_ms(lambda: run(warp_bilinear_plain)) / len(calls)
    print(f"phase 3 K2 warp_bilinear: {len(calls)} compose rects of the "
          f"main path, canvas {g.canvas} ({g.canvas_h}x{g.canvas_w} padded, "
          f"{g.n_bands} bands), source {tuple(calls[0][0].shape)} -> rects "
          f"{sorted((3,) + k for k in g.buckets)}, max |diff| {err:.3g} "
          f"(atol 1e-4), per call: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    return dict(name="warp_bilinear", route="cuda",
                source="image_stitching_tpu_torch/csrc/warp_gather.cu",
                replaces=("image_stitching_tpu/kernels/"
                          "warp_gather_pallas.py:89"),
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.core import image_io
    from image_stitching_tpu_torch.kernels import _build
    from image_stitching_tpu_torch.kernels.orb_sample import orb_sample
    from image_stitching_tpu_torch.kernels.warp_gather import warp_bilinear
    from image_stitching_tpu_torch.pipeline.stitcher import stitch

    dev = torch.device("cuda")
    smi = _smi()
    print(f"phase 0 env: torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, nvidia-smi '{smi}', host codec "
          f"{image_io.codec_name()}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        caps = os.path.join(work, "caps")
        t0 = time.perf_counter()
        k_true, rs_true = write_ring_dir(caps, **E2E_RING)
        print(f"phase 0 captures: {N_IMAGES} x {H}x{W} rendered and written "
              f"in {time.perf_counter() - t0:.3f} s", flush=True)

        _build.load_library()
        print(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
              f"{_build.build_seconds():.3f} s", flush=True)

        paths = image_io.list_images(caps)
        img0 = torch.from_numpy(image_io.orient_capture(
            image_io.imread(paths[0]), False)).to(dev)
        kernels = [check_k1(dev, img0)]

        cfg = StitchConfig(num_features=1500, work_megapix=1.9,
                           expos_comp_type="no", seam_find_type="no",
                           fast_ingest=False, checkpoint_dir=work)
        # The warm-up stitch also gives phase 3 its cameras.
        warm = stitch(caps, cfg, output="", device="cuda")
        kernels.append(check_k2(dev, paths, cfg, warm))
        orb_sample.launches = 0
        warp_bilinear.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = stitch(caps, cfg, output="", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"orb_sample": orb_sample.launches,
                    "warp_bilinear": warp_bilinear.launches}
        pano = res.panorama
        assert pano.ndim == 3 and pano.shape[2] == 3, tuple(pano.shape)
        assert bool(torch.isfinite(pano).all()), "non-finite panorama"
        assert res.kept_indices == list(range(N_IMAGES)), res.kept_indices
        err = reproj_err_px(res.cameras, res.kept_indices, k_true, rs_true,
                            res.work_scale)
        assert err <= 1.0, f"reprojection error {err:.4f} px > 1 px"
        coverage = float(res.mask.float().mean())
        assert coverage > 0.9, f"mask coverage {coverage:.4f}"
        for name, count in launches.items():
            assert count > 0, f"{name} was not launched by the main path"
        stages = ", ".join(f"{k}={v:.4f}s" for k, v in
                           res.stage_times.items())
        print(f"phase 4 e2e: kept {len(res.kept_indices)}/{N_IMAGES}, "
              f"reprojection {err:.4f} px, panorama {tuple(pano.shape)}, "
              f"mask {coverage:.4f}, launches {launches}, wall {wall:.4f} s "
              f"({N_IMAGES * H * W / 1e6 / wall:.3f} MP/s), stages: "
              f"{stages}; card '{smi}'", flush=True)

    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
