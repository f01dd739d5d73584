"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  0. environment: torch, CUDA, the card's name and power limit, the host's
     CPU count, the libjpeg/libpng16 files the native runtime links when it
     is built here; then the captures: an 8-image 2448x3264 spherical
     ring (55 deg FOV, 0.5 overlap) rendered with the port's synth and
     written as JPEGs with EXIF pose priors, twice (each view rendered
     once, its noise drawn at both levels): sigma-4 sensor noise
     (E2E_RING) for the
     work-scale path, sigma 8 (DEFAULT_RING) for the default path, where
     sigma 4 makes some adjacent pairs near-duplicates by the reference's
     confidence rule (see data/synth.py), and sigma 12 for phase 14; and
     phase 10's cyl4 and vga_pair capture sets;
  1. build: the four CUDA kernel sources compiled with nvcc for sm_90a,
     one nvcc per source, all at once, and beside them the native host
     runtime (`native/stitch_runtime.cpp`, g++ against the vendored codec
     headers) unless the tracked library loads; which runtime loaded and
     the codec files it links;
 1b. RANSAC's draws (`core/prng.py`, `jax.random`'s threefry): a
     stitch's worth, split(PRNGKey(0), n) for n = 28 and 666 and under
     each key the uniforms (512, 4) and, under fold_in(key, 1), (1024,),
     on the card and on the CPU, equal bit for bit and equal to a handful
     of jax.random's words (PRNG_GOLDEN, pinned by
     tests/test_torch_prng.py); one threefry call's device ms, launches
     and call ms at 9b's shapes;
  2. K1 (orb_sample_levels) against its plain PyTorch version on every
     level of one work-scale image (1224x1632 level 0, 1500 features), in
     the one launch per image the detector makes, gated on every level;
  3. K2 (warp_bilinear) against its plain version on every compose rect
     of a warm-up stitch() of the work-scale path, and grid_sample timed
     beside it; then on the compose rects of the cyl4 warm-up stitch
     (cylindrical maps, device time per rect) and on a plane-projection
     rect set whose valid coordinates reach past +-2^31;
  4. end to end, the work-scale path: num_features=1500, work_megapix=1.9,
     no exposure compensation, the "no" seam finder, the legacy decode
     (fast_ingest=False); timed after the
     warm-up, held to 8/8 kept, <= 1 px mean pairwise reprojection error
     against the ground truth, mask coverage > 0.9, launches > 0;
  5. K1 on every level of the default path's first capture (4000
     features); K3 is its full-resolution level 0 (2448x3264, 32 MB, past
     the TPU kernel's 11 MB VMEM budget), also launched alone;
  6. K4 (hamming_two_nn_pairs) on the descriptors of a warm-up stitch()
     with the reference defaults (4000 ORB features at full resolution,
     GAIN_BLOCKS exposure, DP colour seams; fast ingest off): all 28 pairs
     in both directions in the one call matching makes, its +-1 unpack
     against pm1_rows, and a tie-heavy stack at K = 4000 (duplicated
     descriptors, images with 1 and 0 valid descriptors);
 6b. K4 at other widths and past the 32-bit key (`check_k4_chunked`,
     `check_k4_wide`): at W = 1, 4, 5, 13, 16 and 32, a random stack of 8
     x K = 4000 (28 pairs both ways), the same with its valid columns in
     runs (the first 84 of each 500, so whole column tiles are skipped)
     and the tie stack against the plain version, indices equal and
     distances exact; match_all_pairs as the default stitch calls it on
     phase 6's ORB features with the descriptors widened by zero words to
     W (12 too; or cut to the first W words below 8), each call under K4's
     count set to 0 just before it and read just after: one launch, and at
     W >= 8 tables, inliers, H and confidences equal to the 8-word call's;
     K4 at each W on those descriptors against its plain version, its
     device, call and plain ms, both bounds and its share of the
     tensor-core bound; then on 64-bit keys and past grid.y: K = 70000 at
     8 words (4 images, 6 pairs both ways; random stack with nearest
     columns past 65535, valid runs, the tie stack) against the plain
     version on every row by blocks, W = 2048 and 4096 at K = 512, and
     363 images of K = 128 (65703 pairs in one call) on 256 of its pairs,
     each with its times and bound;
  7. K5 (pyramid_accumulate) on the compose rects of that warm-up stitch,
     one call per bucket as the compose makes them, its kernel launches
     per call counted in a CUDA graph of the calls (<= 2 n_bands + 1), and
     on three K5_CASES buckets (windows at both canvas edges, clamped and
     odd offsets; 130 images, past one band launch's 128; 0 bands, as
     FEATHER and NO compose, at most 1 launch): accumulators
     within 2e-3, finalized u8 panorama within 1, masks equal; its bound
     counts the union of a call's windows per band; K2 against its plain
     version on the same rects' samples;
  8. end to end, the default path with the legacy decode: timed after the
     warm-up, held to 8/8 kept, <= 1 px reprojection, mask coverage > 0.9,
     finite positive gains, seam-mask union equal to the warped-mask
     union, launches of all five kernels > 0, K1 <= 8 and K4 <= 2
     launches, K5 no more calls than phase 7's buckets (1 on the ring);
     K6 on the stitch's 8 float32 work grays (`rgb_to_gray`'s, with
     fractions) against its plain version, every kept level, all four
     planes bit for bit, one launch a level in the stitch;
  9. fast ingest, the reference default: (a) on the DEFAULT_RING files the
     raw 4:2:0 route is taken for all 8 (pinned buffers); the device RGB
     of the num8-8 planes equals PIL's RGB decode of each file and the Y
     plane PIL's luma decode; at num8 4 the Y plane equals PIL's luma
     decode at half size; the card's fast_prep equals the port's CPU
     fast_prep on the same planes (seam stack within 1), and its time;
     (b) stitch() with exactly StitchConfig() on DEFAULT_RING under phase
     8's gates, its stage table beside phase 8's, and held to the JAX
     package's stitch of the same files on the CPU
     (`tests/data/ring_reference_jax.json`, `tools/ring_reference_jax.py`;
     the same seed, so the same RANSAC draws): kept indices equal, focal
     within rtol 1e-3, adjacent relative rotations within 0.05 degrees,
     each pair's n_inliers and n_matches reported, then K6
     (orb_detect_maps) on that stitch's 8 work grays: every kept level
     against its plain version on the card, all four planes bit for bit,
     one launch a level and 8 a view in the stitch, a view's levels timed
     (device, call and plain ms) against its bound; then K7
     (ransac_score_counts, `check_k7`) on that stitch's one call of 28
     pairs against its plain version on the card, timed likewise; (c) the
     JAX package's
     bench configuration StitchConfig(num_features=1500,
     work_megapix=1.9) (the num8-4 raw route) on E2E_RING under phase 4's
     gates; (d) `python -m image_stitching_tpu_torch` on DEFAULT_RING in a
     process of its own, exit 0 and a JPEG the size of (b)'s panorama.
     Each stitch of (b) and (c) runs with the kernels' counts set to 0
     just before it and read just after; `launches` in the kernel line is
     (b)'s count, the main path, and `launches_by_path` every path's;
 10. the configurations of the JAX package's bench.py that the port adds,
     and the slice's other options, each stitch under the counts as in
     phase 9 (captures rendered in phase 0 as bench.py makes them):
     (a) cyl4, StitchConfig(num_features=1500, warp_type="cylindrical")
     on 4 x 1080x1920 (seed 11 timed after phase 3's warm-up on
     12): walls, MP/s, stage table, reprojection; (b) vga_pair,
     StitchConfig(num_features=1500, blend_type="feather") on 2 x 480x640
     (warm-up on seed 100, p50 wall over 101-103), the K5 calls at 0
     bands, and K5 against its plain version on its rects with its
     0-band device time; (a) and (b) under phase 4's and 8's gates (kept
     n/n, <= 1 px reprojection, mask > 0.9, seam union = warped union,
     every kernel launched); (c) StitchConfig(seam_find_type=s) on
     DEFAULT_RING for voronoi, gc_color and gc_colorgrad under the same
     gates, "Finding seams" beside phase 9b's dp_color; (d)
     StitchConfig(serialize_data=False) from phase 9b's checkpoint: kept
     indices equal, the checkpoint's cameras within the 6-digit text
     format of 9b's bundle adjustment, panorama within mean |diff| 0.5 of
     9b's and masks equal off a 1-pixel edge band, its wall beside 9b's;
     (e) one vga_pair stitch with profile_dir and save_graph_to: a
     non-empty trace and a DOT file with an edge per kept adjacent pair;
 11. camera seeding and the registration variants, each stitch under the
     counts as in phase 9 (captures rendered in phase 0): (a)
     StitchConfig() on DEFAULT_RING written without EXIF (cameras seeded
     by homography_based_estimate): kept 8/8, mask > 0.9, finite
     positive gains, seam union = warped union; its reprojection error,
     focal and per-pair autocalib focals reported, not gated (the
     reference's autocalib is erratic on a pure-yaw ring and the default
     refine mask keeps its focal); and
     StitchConfig(use_sensor_priors=False) on the EXIF files: kept
     indices equal, cameras within 1e-4 (relative); (b) bench.py's
     rig37, StitchConfig(num_features=1000) on 37 x 960x1280 (seed 21),
     timed after a warm-up on its +-2 LSB twin: kept 37/37, <= 1 px
     reprojection over the pairs within 45 deg, mask > 0.9, seam union =
     warped union; its wall, MP/s, stage table, launches and peak device
     memory; K4 on its 666 pairs in one call and K5 on every bucket of its
     compose against their plain versions; K7 on its RANSAC blocks' calls
     as one of 666 pairs; (c) StitchConfig(
     num_features=1000, infill_dropped=True) on rig37 with frames 5, 15
     and 30 made noise: the component removed them, 37 cameras come back,
     each infilled camera within 1 deg of the ground truth relative to the
     neighbour it was made from; (d) the affine scan mode (matcher,
     estimator, BA and warp "affine", no wave correction) on a 2x2 mosaic
     of 1080x1920 tiles without EXIF, each tile a similarity of one
     planar texture: kept 4/4, each tile's similarity within 0.5 deg and
     1% scale of the truth relative to tile 0, the mask over 0.9 of the
     warped tiles' union, K2 on its compose rects; (e)
     StitchConfig(ba_cost_func="ray") on DEFAULT_RING under phase 9b's
     gates;
 12. the loop compose, each stitch under the counts as in phase 9
     (captures rendered in phase 0): (a) mixed8, StitchConfig() on
     DEFAULT_RING's geometry with views 0, 2, 4, 6 at 2448x3264 and 1, 3,
     5, 7 at 3000x4000, each at its own K and EXIF payload, after a
     warm-up on the same files: fast ingest declines it, kept 8/8, <= 1 px
     reprojection (per-image K), mask > 0.9, finite positive gains (the
     host feed), seam union = warped union, every kernel launched; its
     wall, MP/s, peak device memory; K2 on the loop compose's rects and K5
     on the loop blender's calls (a bucket of one each) against their
     plain versions under phase 3's and 7's gates, device, call and plain
     ms per call and their bounds; (b) StitchConfig(timelapse=True,
     timelapse_type="as_is") on DEFAULT_RING in a working directory of its
     own: 8 fixed_*.jpg frames of the union canvas's size, no result.jpg,
     its "Compositing" beside phase 9b's; (c) bench.py's spher16,
     StitchConfig(crop_result=True) on 16 x 3000x4000 (55 deg, overlap
     0.45, seed 41, sigma-8 noise), timed after a warm-up on its +-2 LSB
     twin: kept 16/16, <= 1 px reprojection, the cropped panorama smaller
     than the canvas with a clean border (check_interior_exterior of its
     gray > 0 mask finished); its wall, MP/s, peak device memory, the
     crop's host time, and the stage table of 9b, 12a, 12b and 12c;
 13. the strip-streamed compose and bench.py's mosaic100 and gigapixel,
     under the counts as in phase 9: (a) StitchConfig(compose_strips_mp=
     half of 9b's canvas MP, compose_strip_w=a quarter of its width) on
     DEFAULT_RING: the stitch takes fused_compose_strips (>= 3 strips),
     its host panorama's mask equals 9b's, mean |diff| < 0.5 and p99 <= 2
     over it, "Compositing" beside 9b's; (b) mosaic100,
     StitchConfig(range_width=3) on 100 x 480x640 (fov 8, overlap 0.55,
     seed 31, detailed texture, rendered in phase 0), timed after a
     warm-up on its +-2 LSB twin: kept 100/100, <= 1 px reprojection,
     every kernel launched; its wall, MP/s, stage table, peak device
     memory, and K4 on its 197 pairs; (c) gigapixel: 12 x 24 tiles of
     1024x1536 at focal 6000 made on the device (CUDA generator seeded 1
     for a warm pass, 2 timed), the seam-scale prep (warp_stack,
     feed_device GAIN_BLOCKS, dp_color seams), then fused_compose_strips
     of the 271.2 MP canvas in strips of 4096 into a u8 host panorama:
     coverage > 0.5, the compose's peak device memory below the tiles
     plus the whole-canvas band accumulators; its seconds, canvas MP/s and
     peak beside its terms; (d) K2 and K5 on one K5 call of the strip
     with the most rects (9 bands) against their plain versions under
     phase 3's and 7's gates, device, call and plain ms and the bounds,
     grid_sample beside K2;
 14. the other detectors, under the counts as in phase 9: for sift, surf
     and akaze, StitchConfig(features_type=X, match_conf 0.65 for the
     float descriptors, 0.32 for AKAZE) on DEFAULT_RING, a warm-up and a
     timed stitch: K2 and K5 launched (and K4 for AKAZE), K1 not; kept
     8/8, <= 1 px reprojection, mask > 0.9, seam union = warped union;
     where the reference's near-duplicate rule drops views (SIFT, SURF)
     every zeroed adjacent pair must have a raw confidence above 3, the
     numbers are printed ungated, and the detector stitches the sigma-12
     ring under those gates (SIFT at 1500 features); the stage table
     beside 9b's, wall, MP/s and peak device memory; the
     detector on the card against the same module on the CPU on view 0
     at full size (equal valid counts, >= 99% of the keypoints paired
     within 1e-2 px and 1e-3 rad, >= 99% of the paired descriptors within
     1e-4 or, for AKAZE, bit flips only where the compared means differ
     by < 1e-3; the rest counted); for AKAZE, K4 at 12 words on the
     stitch's 28 pairs in one call against its plain version (and its
     unpack against pm1_rows, a tie-heavy stack at 12 words) with its
     device, call and plain ms and bound; SIFT's peak device memory on
     one view;
 15. the JAX package's bench.py configurations outside stitch(), each
     under the counts as in phase 9: (a) gp_sharded (bench.py:734-791):
     12 x 1024x1536x3 noise (numpy seed 0), focal 1400, spherical, yaws
     0.5 i, full seam masks, no compensator, MULTI_BAND at strength 5,
     through fused_compose_sharded on a (1, 4) mesh of this card (the
     shards one after another): after a warm-up, ms per composite over 3
     reps with fresh content, download included, canvas MP/s, peak device
     memory and the band count; against fused_compose on the same inputs
     with tests/test_parallel.py:74-136's bounds (the same shape, mean
     |diff| < 0.5 and p99 <= 2 over both masks; FEATHER exact); K2 on a
     shard's samples and K5 on its call against their plain versions
     (phase 3's and 7's gates) with device, call and plain ms and the
     bounds; (b) pairs (bench.py:527-558): make_batched_register on a dp
     mesh of this card, 64 noise pairs of 480x640 (seed 0), 1024
     features, n_hyp 512, pairs/s over 3 reps after a warm-up; 8 pairs of
     a noise base and its roll by (7, 5): every n_inliers > 20, one
     register_pair a pair with the same keys (split(PRNGKey(0), B), as
     bench.py:537 makes them) and a dp-2 mesh
     of this card against dp 1 (n_inliers equal, H within 1e-4 of its
     largest entry, `h_close`); K1 on one image and K4 on the batch's 64
     pairs against their plain versions with their bounds; K6 on the
     batch's 128 float32 images, every kept level, all four planes bit
     for bit against its plain version, one launch a level.  The
     multi-process path (`parallel/distributed.py`) is held on CPU
     processes only (tests/test_torch_distributed.py): NCCL cannot put
     two ranks on one card;
 16. the slice's path past the 32-bit key: StitchConfig(num_features=
     70000) on DEFAULT_RING (the JAX CLI's `--num-features 70000`) under
     the counts as in phase 9: one K4 call, on 64-bit keys, held to its
     plain version on three slices of rows; kept views, reprojection and
     wall printed, not gated (the reference's near-duplicate rule may drop
     views at this many matches).
Each kernel row gives `device_ms`, the device time per call from CUDA
events around a replayed CUDA graph of the calls (L2 warm, the host
wrapper left out; also `ms`), `call_ms`, CUDA events around back-to-back
wrapper calls (what the caller pays), the plain version's time by the
same events, the bound, and the library call's device time, by the same
graph, where one computes the same function; K2's row also its device
time on the cylindrical rects (`cylindrical_device_ms`) and the affine
scan's (`affine_device_ms`), K5's its device time and launches per call
at 0 bands on the vga_pair rects (`zero_band_device_ms`,
`zero_band_launches_per_call`, `zero_band_bound_ms`); K4's and K5's rows
their rig37 times and bounds (`rig37_*`); K2's and K5's rows their times,
bounds and errors on
mixed8's loop compose (`loop_*`) and on a gigapixel strip (`strip_*`);
K4's row its mosaic100 times and bound (`mosaic100_*`); K2's and K5's
rows their times, bounds and errors on a gp_sharded shard (`shard_*`),
K1's and K4's on the pairs batch (`pairs_*`).  A sixth row is
K4 at 12 words (`words: 12`), checked and timed on phase 14's AKAZE
descriptors, its launches those of phase 14's stitches; then one K4 row
for each W of phase 6b, its launches those of its match_all_pairs call,
and one each for K = 70000 (its launches phase 16's; `stitch_*` that
stitch's K4 call), W = 2048, W = 4096 and 65703 pairs (`key_bits` each
row's key width; launches those of phase 6b's call).  Every K4 row is
the one kernel, `csrc/hamming_chunked.cu`.  The last rows are K6's and
K7's (`check_k7`: phase 9b's 28-pair call, and phase 11b's rig37 calls as
one of 666 pairs, `rig37_*`).
Then the smoke's total seconds and phase 15's end-to-end numbers, a JSON
line of those kernel results with the launches on the path the kernel was
checked on (`launches_by_path` every path's, phases 15a, 15b and 16
included), the nvidia-smi line, and a last JSON line {"ok": true, "device": {...}}.  Without a CUDA
device it exits non-zero and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from image_stitching_tpu_torch.core.logging import Recorder
from image_stitching_tpu_torch.data.synth import DEFAULT_RING, E2E_RING

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = E2E_RING["n_images"]
H, W = E2E_RING["hw"]

# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s, the
# float32 rate outside the tensor cores, the only CUDA-core rate listed
# there, used for the kernels' 32-bit integer and float operations alike,
# and the dense int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12
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


def reproj_err_px(cameras, kept, k_true, rs_true, work_scale: float,
                  hw=(H, W), pairs=None):
    """Mean pairwise reprojection error (px) of the kept images of size hw,
    over `pairs` of positions in `kept` (default consecutive ones):
    estimated K_b R_b R_a^T K_a^-1 against the ground truth on an 8x8 pixel
    grid of image a (gauge-invariant; bench.py `_reproj_err_px`).  k_true
    and hw may also be lists, one K and one (h, w) per capture, for a set
    of mixed sizes."""
    n_all = len(rs_true)
    ks_true = list(k_true) if isinstance(k_true, list) else [k_true] * n_all
    hws = list(hw) if isinstance(hw, list) else [hw] * n_all
    c = cameras.numpy()
    kc = np.zeros((len(kept), 3, 3))
    kc[:, 0, 0] = c["focal"]
    kc[:, 0, 2] = c["ppx"]
    kc[:, 1, 1] = c["focal"] * c["aspect"]
    kc[:, 1, 2] = c["ppy"]
    kc[:, 2, 2] = 1.0
    kc[:, :2, :] /= work_scale
    rc = np.asarray(c["R"], np.float64)

    def proj(m, hw_a):
        gy, gx = np.meshgrid(np.linspace(0, hw_a[0] - 1, 8),
                             np.linspace(0, hw_a[1] - 1, 8))
        q = m @ np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], axis=0)
        return q[:2] / np.where(np.abs(q[2:]) < 1e-12, 1e-12, q[2:])
    errs = []
    if pairs is None:
        pairs = [(a, a + 1) for a in range(len(kept) - 1)]
    for a, b in pairs:
        ia, ib = kept[a], kept[b]
        h_est = kc[b] @ rc[b].T @ rc[a] @ np.linalg.inv(kc[a])
        h_gt = (ks_true[ib] @ rs_true[ib].T @ rs_true[ia]
                @ np.linalg.inv(ks_true[ia]))
        errs.append(np.linalg.norm(proj(h_est, hws[ia]) -
                                   proj(h_gt, hws[ia]), axis=0).mean())
    return float(np.mean(errs))


def time_ms(fn, reps: int = 20) -> float:
    """Mean time of one fn() call over `reps` calls back to back, CUDA
    events around them: the host wrapper's enqueue is in it, so for a
    short kernel this is what a caller pays (`call_ms`), not the kernel."""
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


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call: CUDA events around the replays of a
    CUDA graph that holds `reps` fn() calls.  The graph replays the
    kernels alone, so the host wrapper (checks, allocation, enqueue) is
    not in it; the graph's kernel-to-kernel launch gaps are.  fn must
    launch nothing but the kernels it times (the port's wrappers
    allocate with torch.empty and launch).  The inputs stay in L2 between
    calls, as the stitch finds them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def kernel_launches(fn) -> int:
    """Kernel launches of one fn() call: the kernel nodes of a CUDA graph
    captured from it (fn must launch only what it counts, as for
    device_ms), read back by cuGraphGetNodes and cuGraphNodeGetType."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kernels += kind.value == 0      # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def _level_gates(dev, lv, xy, s_k, a_k, m_k, d_k, s_p, a_p, m_p, d_p, pat):
    """K1's gates on one level's keypoints (level plane lv): moments
    within 1e-5 of their magnitude, samples equal where the rounded
    coordinates agree, <= 1e-4 of the descriptor bits flipped.  Returns
    (moment error, samples unequal at agreeing coords, coords disagreeing,
    flips, bits, disk pixel ids, sample pixel ids)."""
    h, w = lv.shape
    # Moments: |dm| <= 1e-5 of the sum of |v * d| over the disk (the scale
    # of float32 summation error, where a relative error of the cancelled
    # sum itself is not).
    ys, xs = np.mgrid[-20:21, -20:21]
    disk = (xs * xs + ys * ys) <= 400
    cx = torch.round(xy[:, 0]).long().clamp(0, w - 1)
    cy = torch.round(xy[:, 1]).long().clamp(0, h - 1)
    dys = torch.as_tensor(ys[disk], device=dev)
    dxs = torch.as_tensor(xs[disk], device=dev)
    rows = (cy[:, None] + dys).clamp(0, h - 1)
    cols = (cx[:, None] + dxs).clamp(0, w - 1)
    vals = lv[rows, cols]
    mag = torch.stack([(vals * dxs.abs()).sum(1), (vals * dys.abs()).sum(1)],
                      -1)
    mom_rel = float(((m_k - m_p).abs() / mag.clamp(min=1.0)).max())

    def coords(ang):
        ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        gx = torch.round(xy[:, 0:1] + (ca * pat[0] - sa * pat[1]))
        gy = torch.round(xy[:, 1:2] + (sa * pat[0] + ca * pat[1]))
        return gx.clamp(0, w - 1).long(), gy.clamp(0, h - 1).long()
    gxk, gyk = coords(a_k)
    gxp, gyp = coords(a_p)
    agree = (gxk == gxp) & (gyk == gyp)
    bad = int(((s_k != s_p) & agree).sum())
    bits_k = ((d_k[..., None] >> torch.arange(32, device=dev)) & 1)
    bits_p = ((d_p[..., None] >> torch.arange(32, device=dev)) & 1)
    flips = int((bits_k != bits_p).sum())
    return (mom_rel, bad, int((~agree).sum()), flips, bits_k.numel(),
            torch.unique(rows * w + cols), torch.unique(gyk * w + gxk))


def check_k1(dev, gray, n_features: int, phase: str, name: str,
             replaces: str):
    """K1 on every level of one main-path image: the level planes and
    keypoints `detect_levels` gives the describe step, in the one
    `orb_sample_levels` launch the detector makes.  Returns the row of
    that launch and, for K3, the row of a launch of level 0 alone."""
    from image_stitching_tpu_torch.ops.features.orb import (
        detect_levels, pattern_xy, resolve_pattern)
    levels = detect_levels(gray, n_features)
    pat = pattern_xy(resolve_pattern(None), dev)
    ks = [lv[3].shape[0] for lv in levels]
    lvl = torch.cat([torch.full((k,), i, dtype=torch.int32, device=dev)
                     for i, k in enumerate(ks)])
    return k1_launch_check(
        dev, [lv[1] for lv in levels], [lv[2] for lv in levels],
        torch.cat([lv[3] for lv in levels]), lvl, pat,
        [int(lv[5].sum()) for lv in levels], phase, name, replaces)


def k1_launch_check(dev, raws, blurs, xy, lvl, pat, valid, phase: str,
                    name: str, replaces: str):
    """`check_k1` on one launch's inputs (level planes, blurred planes,
    keypoints, level index, pattern), `valid` the valid keypoints per
    level where known."""
    from image_stitching_tpu_torch.kernels.orb_sample import (
        orb_sample_levels, orb_sample_levels_plain, N_SAMPLES)
    ks = torch.bincount(lvl.long(), minlength=len(raws)).tolist()
    out_k = orb_sample_levels(raws, blurs, xy, lvl, pat, 20,
                              with_samples=True)
    out_p = orb_sample_levels_plain(raws, blurs, xy, lvl, pat, 20,
                                    with_samples=True)
    torch.cuda.synchronize()
    per_level, px = [], []
    for i, (raw, k_l) in enumerate(zip(raws, ks)):
        sel = lvl == i
        g = _level_gates(dev, raw, xy[sel], *(x[sel] for x in out_k),
                         *(x[sel] for x in out_p), pat)
        mom_rel, bad, disagree, flips, n_bits = g[:5]
        assert mom_rel <= 1e-5, \
            f"K1 level {i} moments differ: {mom_rel:.3g} of magnitude"
        assert bad == 0, f"K1 level {i}: samples differ at {bad} coords"
        assert flips <= 1e-4 * n_bits, f"K1 level {i}: {flips} bits flipped"
        per_level.append(g[:5])
        px.append((int(g[5].numel()), int(g[6].numel())))
    max_err = float((out_k[0] - out_p[0]).abs().max())

    def row(sel_levels, label):
        """Times and bound of one launch over `sel_levels`."""
        sel = torch.isin(lvl, torch.as_tensor(sel_levels, dtype=torch.int32,
                                              device=dev))
        args = ([raws[i] for i in sel_levels], [blurs[i] for i in sel_levels],
                xy[sel].contiguous(),
                (lvl[sel] - sel_levels[0]).contiguous(), pat, 20)
        n0 = orb_sample_levels.launches
        orb_sample_levels(*args)
        n_launch = orb_sample_levels.launches - n0
        dev_ms = device_ms(lambda: orb_sample_levels(*args))
        call_ms = time_ms(lambda: orb_sample_levels(*args))
        plain_ms = time_ms(lambda: orb_sample_levels_plain(*args))
        # Bytes: the pixels this launch's keypoints need, each read once
        # (per level the union of their disks in the raw plane and of
        # their rounded sample coordinates in the blurred plane), keypoints,
        # levels and pattern in; angle, moments and descriptors out (the
        # main path asks for no samples).  Operations: per keypoint the
        # disk's two moment sums, the 512 rotations and rounds, 256
        # compares.
        k_n = int(sel.sum())
        n_px = sum(sum(px[i]) for i in sel_levels)
        n_bytes = 4 * n_px + k_n * (8 + 4) + pat.numel() * 4 + \
            k_n * (4 + 8 + 32)
        ys, xs = np.mgrid[-20:21, -20:21]
        disk_px = int(((xs * xs + ys * ys) <= 400).sum())
        n_ops = k_n * (disk_px * 4 + N_SAMPLES * 8 + 256)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"phase {phase} {label}: levels {sel_levels}, K={k_n}, "
              f"{n_launch} launch per call; device {dev_ms:.4f} ms, call "
              f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_px} pixels read, {n_bytes} "
              f"bytes in all)", flush=True)
        return dict(route="cuda",
                    source="image_stitching_tpu_torch/csrc/orb_sample.cu",
                    replaces=replaces, max_abs_err=max_err, ms=dev_ms,
                    device_ms=dev_ms, call_ms=call_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    plane = raws[0].numel() * 4
    print(f"phase {phase} K1 orb_sample_levels: image "
          f"{tuple(raws[0].shape)} (level 0 {plane} bytes, "
          f"{plane / TPU_VMEM_BUDGET:.2f}x the TPU kernel's "
          f"{TPU_VMEM_BUDGET}-byte VMEM budget), {len(raws)} levels, K per "
          f"level {ks} (valid {valid}); per level moments max "
          f"|dm|/magnitude {[f'{g[0]:.3g}' for g in per_level]} (tol 1e-5), "
          f"samples unequal at agreeing coords {[g[1] for g in per_level]}, "
          f"coords disagreeing {[g[2] for g in per_level]}, bit flips "
          f"{[f'{g[3]}/{g[4]}' for g in per_level]} (tol 1e-4)", flush=True)
    full = row(list(range(len(raws))), "K1 one launch, every level")
    full["name"] = name
    level0 = row([0], "K1 level 0 alone")
    return full, level0

# Operations a level pixel needs, counted once each (no halo recompute):
# the resize's two row fmas and one column fma (9), FAST's 32 compares,
# 64 bit packs and two 9-arc tests (160), Sobel and the products (23), the
# box sums (3 x 49), Harris's det, trace and scale (7), the 3x3 NMS (9),
# the blur's 2 x 7 taps (28).
K6_OPS_PER_PIXEL = 9 + 160 + 23 + 147 + 7 + 9 + 28


def _resize_taps(n_src: int, n_dst: int) -> int:
    """Source rows (or columns) `resize` reads for n_dst outputs."""
    s = np.float64(np.float32(n_src / n_dst))
    src = ((np.arange(n_dst) + 0.5) * s - 0.5).astype(np.float32)
    y0 = np.clip(np.floor(src), 0, n_src - 1).astype(np.int64)
    return int(np.unique(np.concatenate(
        [y0, np.minimum(y0 + 1, n_src - 1)])).size)


def k6_equal(grays, path_launches: int, phase: str):
    """K6 (orb_detect_maps) on each (H, W) image of `grays`, every level
    ORB keeps, against its plain version on the card: all four planes bit
    for bit, one launch a call; the path that detected on `grays` made
    one launch a level and image.  Returns the levels (level, lh, lw)."""
    from image_stitching_tpu_torch.kernels.orb_detect import (
        orb_detect_maps, orb_detect_maps_plain)
    from image_stitching_tpu_torch.ops.imgproc import scale_size
    h, w = grays[0].shape
    levels = [(lv,) + scale_size(h, w, 1.0 / 1.2 ** lv) for lv in range(8)]
    levels = [lv for lv in levels if min(lv[1:]) >= 48]
    names = ("plane", "blur", "harris", "rank")
    for i, gray in enumerate(grays):
        gray = gray.contiguous()        # as detect_levels takes it
        for lv, lh, lw in levels:
            before = orb_detect_maps.launches
            got = orb_detect_maps(gray, lv, lh, lw)
            assert orb_detect_maps.launches == before + 1
            want = orb_detect_maps_plain(gray, lv, lh, lw)
            for name, a, b in zip(names, got, want):
                assert torch.equal(a.view(torch.int32),
                                   b.view(torch.int32)), \
                    f"phase {phase} K6 image {i} level {lv}: {name} " \
                    f"differs from plain"
        del got, want
    assert path_launches == len(grays) * len(levels), \
        (phase, path_launches)
    print(f"phase {phase} K6 orb_detect_maps: {len(grays)} images of "
          f"{h}x{w} {grays[0].dtype}, levels {[lv[1:] for lv in levels]}, "
          f"all four planes equal to plain bit for bit, 1 launch a call, "
          f"{path_launches} launches on the path", flush=True)
    return levels


def check_k6(dev, grays, stitch_launches: int):
    """K6 on the main path's work images (phase 9b's fast_prep grays, u8
    at full resolution): `k6_equal`, then one launch a level counted as
    the kernel nodes of a CUDA graph, and a view's levels timed as one
    call (device ms by CUDA graph replays, call ms, plain ms) against the
    bound: the image once per level (the source rows and columns its
    resize reads) in, the four f32 planes out, and K6_OPS_PER_PIXEL a
    level pixel."""
    from image_stitching_tpu_torch.kernels.orb_detect import (
        orb_detect_maps, orb_detect_maps_plain)
    n_img, h, w = grays.shape
    levels = k6_equal(grays, stitch_launches, "9b")
    per_level = [kernel_launches(lambda: orb_detect_maps(grays[0], *lv))
                 for lv in levels]
    assert per_level == [1] * len(levels), per_level

    def view():
        for lv in levels:
            orb_detect_maps(grays[0], *lv)

    def plain():
        for lv in levels:
            orb_detect_maps_plain(grays[0], *lv)
    dev_ms = device_ms(view)
    call_ms = time_ms(view)
    plain_ms = time_ms(plain, reps=3)
    px = sum(lh * lw for _, lh, lw in levels)
    n_in = sum(h * w if lv == 0 else _resize_taps(h, lh) * _resize_taps(w, lw)
               for lv, lh, lw in levels) * grays.element_size()
    n_bytes = n_in + 4 * 4 * px
    n_ops = K6_OPS_PER_PIXEL * px
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"phase 9b K6 orb_detect_maps: {n_img} views of {h}x{w} "
          f"{grays.dtype}, levels {[lv[1:] for lv in levels]}, all four "
          f"planes equal to plain bit for bit; 1 launch a level; a view: "
          f"device {dev_ms:.4f} ms, call {call_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_bytes} bytes {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
          f"{n_ops} operations {n_ops / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms); "
          f"{stitch_launches} launches in 9b's stitch", flush=True)
    return dict(name="orb_detect_maps", route="cuda",
                source="image_stitching_tpu_torch/csrc/orb_detect.cu",
                replaces="none (the eager chain of ops/features/orb.py)",
                max_abs_err=0.0, ms=dev_ms, device_ms=dev_ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, levels=len(levels))


# A K7 point test: three rows of H times (x, y, 1), a multiply, an fma
# and an add each (12), two divisions, two subtractions and the squared
# error (3); the z guard and the compare are not counted.
K7_OPS_PER_TEST = 12 + 2 + 2 + 3
# Pairs a plain call takes at once: its (P, n_hyp, m, 3) temporaries.
K7_PLAIN_PAIRS = 16


def check_k7(calls, phase: str, path_launches: int):
    """K7 (ransac_score_counts) on the calls one stitch made (Recorder on
    `ops.ransac`), their pairs concatenated into one call: the counts
    against the plain version on the card (K7_PLAIN_PAIRS pairs at a
    time), equal on >= 99.9% of the hypotheses and off by one at most,
    only where a point's squared error lies within 1e-3 of thresh^2
    (relative, tests/test_torch_ransac_score.py's gate); one launch a call
    counted as the kernel nodes of a CUDA graph; device ms by CUDA graph
    replays, call and plain ms against the bound: K7_OPS_PER_TEST a point
    test, and the hypotheses and scoring indices in, the points they
    gather once a pair, the counts out."""
    from image_stitching_tpu_torch.kernels.ransac_score import (
        apply_h, ransac_score_counts, ransac_score_counts_plain)
    args = [torch.cat([c[0][i] for c in calls]) for i in range(4)]
    thresh = calls[0][0][4]
    h_all, src, dst, idx = args
    p, n_hyp = h_all.shape[:2]
    m = idx.shape[1]
    got = ransac_score_counts(*args, thresh)
    diffs, unexplained = [], 0
    for a in range(0, p, K7_PLAIN_PAIRS):
        cut = [x[a:a + K7_PLAIN_PAIRS] for x in args]
        want = ransac_score_counts_plain(*cut, thresh)
        n = cut[0].shape[1]
        src_s = torch.gather(cut[1], 1, cut[3][..., None].expand(-1, -1, 2))
        dst_s = torch.gather(cut[2], 1, cut[3][..., None].expand(-1, -1, 2))
        err2 = torch.sum((apply_h(cut[0], src_s[:, None].expand(
            -1, n, -1, -1)) - dst_s[:, None]) ** 2, dim=-1)
        near = (torch.abs(err2 / (thresh * thresh) - 1.0) <= 1e-3).sum(-1)
        diff = got[a:a + K7_PLAIN_PAIRS] - want
        unexplained += int(((diff != 0) & (near == 0)).sum())
        diffs.append(diff)
        del want, err2, src_s, dst_s
    diff = torch.cat(diffs)
    max_diff = int(diff.abs().max())
    equal = float((diff == 0).float().mean())
    assert max_diff <= 1 and equal >= 0.999 and unexplained == 0, \
        (phase, max_diff, equal, unexplained)
    launches = kernel_launches(lambda: ransac_score_counts(*args, thresh))
    assert launches == 1, launches
    dev_ms = device_ms(lambda: ransac_score_counts(*args, thresh))
    call_ms = time_ms(lambda: ransac_score_counts(*args, thresh))

    def plain():
        for a in range(0, p, K7_PLAIN_PAIRS):
            ransac_score_counts_plain(
                *(x[a:a + K7_PLAIN_PAIRS] for x in args), thresh)
    plain_ms = time_ms(plain, reps=3)
    tests = p * n_hyp * m
    n_bytes = p * n_hyp * (36 + 8) + p * m * (8 + 16)
    bound_ms, bound_by = bound(n_bytes, K7_OPS_PER_TEST * tests)
    print(f"phase {phase} K7 ransac_score_counts: the stitch's "
          f"{len(calls)} calls as one of {p} pairs x {n_hyp} hypotheses x "
          f"{m} scoring points (M = {src.shape[1]}): counts equal to plain "
          f"on {equal:.6f} of the hypotheses, largest difference "
          f"{max_diff} (each at a point within 1e-3 of thresh^2); 1 launch "
          f"a call, {path_launches} in the stitch; device {dev_ms:.4f} ms, "
          f"call {call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {n_bytes} bytes, "
          f"{K7_OPS_PER_TEST * tests} operations), "
          f"{bound_ms / dev_ms:.1%} of it reached", flush=True)
    return dict(name="ransac_score_counts", route="cuda",
                source="image_stitching_tpu_torch/csrc/ransac_score.cu",
                replaces="none (the eager scoring of ops/ransac.py::"
                         "ransac_homography)",
                max_abs_err=float(max_diff), equal_share=equal, ms=dev_ms,
                device_ms=dev_ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                pairs=p, n_hyp=n_hyp, m=m, calls=len(calls))


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


def k2_bound(calls):
    """K2's bound per call over (src, sx, sy) calls: the source planes and
    the two maps in, the 3 output planes out, and 3 x 8 tap operations plus
    20 of index arithmetic per sample."""
    n_bytes = sum(src.numel() * 4 + sx.numel() * 4 * (2 + 3)
                  for src, sx, _ in calls) / len(calls)
    n_ops = sum(sx.numel() * (3 * 8 + 20) for _, sx, _ in calls) / len(calls)
    return bound(n_bytes, n_ops)


def k2_library_ms(calls):
    """(device ms, call ms) per rect of the yardstick, never called by the
    port: one grid_sample per rect on the same samples (planar source,
    normalised grid, made beforehand).  Its reflection pads about the edge
    pixels' centres, K2 about their edges."""
    lib_in = []
    for src, sx, sy in calls:
        hc, wc = src.shape[0], src.shape[1]
        grid = torch.stack([sx / (wc - 1) * 2 - 1, sy / (hc - 1) * 2 - 1],
                           -1)[None]
        lib_in.append((src.permute(2, 0, 1)[None].contiguous(), grid))

    def lib_run():
        for x, grd in lib_in:
            torch.nn.functional.grid_sample(x, grd, mode="bilinear",
                                            padding_mode="reflection",
                                            align_corners=True)
    return (device_ms(lib_run) / len(calls), time_ms(lib_run) / len(calls))


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
    comp = compose_inputs(res.cameras, [(H, W)] * len(res.kept_indices),
                          res.work_scale, cfg.compose_megapix, cfg.warp_type)
    g = compose_rects(comp.corners, comp.sizes, cfg.blend_type,
                      cfg.blend_strength)
    calls = []
    for (bh, bw), idxs in sorted(g.buckets.items()):
        for i in idxs:
            im = torch.from_numpy(image_io.orient_capture(image_io.imread(
                paths[res.kept_indices[i]]), False)).to(dev)
            if comp.resize_hws is not None:
                im = resize(im, comp.resize_hws[i])
            us, vs = rect_grid(g.tls[i], bh, bw, dev)
            sx, sy, _ = backward_xy_1d(
                comp.warper.proj_name, us, vs,
                torch.as_tensor(comp.ks[i], device=dev),
                torch.as_tensor(comp.rs[i], device=dev), comp.warper.scale)
            calls.append((im.to(torch.float32).contiguous(), sx.contiguous(),
                          sy.contiguous()))
    err = k2_max_diff(calls)

    def run(fn):
        for src, sx, sy in calls:
            fn(src, sx, sy)
    dev_ms = device_ms(lambda: run(warp_bilinear)) / len(calls)
    call_ms = time_ms(lambda: run(warp_bilinear)) / len(calls)
    plain_ms = time_ms(lambda: run(warp_bilinear_plain)) / len(calls)
    library_ms, lib_call_ms = k2_library_ms(calls)
    bound_ms, bound_by = k2_bound(calls)
    print(f"phase 3 K2 warp_bilinear: {len(calls)} compose rects of the "
          f"main path, canvas {g.canvas} ({g.canvas_h}x{g.canvas_w} padded, "
          f"{g.n_bands} bands), source {tuple(calls[0][0].shape)} -> rects "
          f"{sorted((3,) + k for k in g.buckets)}, max |diff| {err:.3g} "
          f"(atol 1e-4), per rect: kernel device {dev_ms:.4f} ms, call "
          f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample device "
          f"{library_ms:.4f} ms (call {lib_call_ms:.4f} ms), bound "
          f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / dev_ms:.1%} of it "
          f"reached)", flush=True)
    return dict(name="warp_bilinear", route="cuda",
                source="image_stitching_tpu_torch/csrc/warp_gather.cu",
                replaces=("image_stitching_tpu/kernels/"
                          "warp_gather_pallas.py:89"),
                max_abs_err=err, ms=dev_ms, device_ms=dev_ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _k4_equal(got, want, what: str) -> None:
    """i1, d1, d2 equal; i2 equal wherever d2 < 2^30 (both directions)."""
    big = float(2 ** 30)
    for side, g, w in zip(("forward", "reverse"), got, want):
        for m in (0, 1, 3):
            assert torch.equal(g[m], w[m]), \
                f"K4 {what} {side} output {m} differs from its plain version"
        real = w[3] < big
        assert torch.equal(g[2][real], w[2][real]), f"K4 {what} {side} i2"


def _tie_stack(dev, k: int = 4000, seed: int = 0, words: int = 8):
    """Four images of K descriptors of `words` words: image 1 repeats rows
    of image 0 (each twice, so both nearest columns tie at distance 0) and
    image 0 holds duplicates (ties in reverse); image 2 has one valid
    descriptor, image 3 none."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (4, k, words), dtype=np.uint64).astype(
        np.uint32)
    d[0, k // 2:] = d[0, :k - k // 2]
    src = rng.integers(0, k // 2, k)
    d[1] = d[0, src]
    valid = rng.random((4, k)) > 0.1
    valid[2] = False
    valid[2, k // 3] = True
    valid[3] = False
    iu, ju = np.triu_indices(4, 1)
    return (torch.as_tensor(d.view(np.int32), device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(iu, dtype=torch.int32, device=dev),
            torch.as_tensor(ju, dtype=torch.int32, device=dev))


def k4_args(dev, feats, range_width: int = -1):
    """K4's arguments as match_all_pairs makes them for a features stack:
    every pair i < j (within range_width when > 0), both directions in one
    call."""
    n = feats.xy.shape[0]
    iu, ju = np.triu_indices(n, 1)
    if range_width > 0:
        keep = (ju - iu) < range_width
        iu, ju = iu[keep], ju[keep]
    return (feats.desc.contiguous(), feats.valid.contiguous(),
            torch.as_tensor(iu, dtype=torch.int32, device=dev),
            torch.as_tensor(ju, dtype=torch.int32, device=dev))


def k4_bound(args, valid):
    """K4's bound over the distances this data needs (valid rows against
    valid columns, per pair and direction).  With W descriptor words, CUDA
    cores: W XOR, W POPC, W - 1 adds and one compare each at the float32
    peak (24 at W = 8); tensor cores: a 32 W-deep int8 dot product, 64 W
    operations (512 at W = 8), at the int8 dense peak.  Bytes: the packed
    descriptors and validity in, four (2, P, K) outputs of 8 + 4 + 8 + 4
    bytes a row out."""
    k, words = args[0].shape[1], args[0].shape[2]
    nv = valid.sum(-1).double()
    n_dist = float(2 * (nv[args[2].long()] * nv[args[3].long()]).sum())
    n_bytes = args[0].numel() * 4 + args[1].numel() + 2 * len(args[2]) * \
        k * 24
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    cuda_core_ms = max(t_bytes, 3 * words * n_dist / CUDA_CORE_OPS_PER_S *
                       1e3)
    tensor_ms = max(t_bytes, 64 * words * n_dist / INT8_TENSOR_OPS_PER_S *
                    1e3)
    bound_ms = min(cuda_core_ms, tensor_ms)
    return dict(n_dist=n_dist, t_bytes=t_bytes, cuda_core_ms=cuda_core_ms,
                tensor_ms=tensor_ms, bound_ms=bound_ms,
                bound_by="operations" if bound_ms > t_bytes else "bytes",
                route=("tensor cores, int8" if tensor_ms <= cuda_core_ms
                       else "CUDA cores"))


def k4_times(args, valid):
    """K4 against its plain version on `args` (one launch counted), then
    its device, call and plain times per call and `k4_bound`."""
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_pairs, hamming_two_nn_pairs_plain)
    words = args[0].shape[2]
    before = hamming_two_nn_pairs.launches
    _k4_equal(hamming_two_nn_pairs(*args), hamming_two_nn_pairs_plain(*args),
              f"{len(args[2])} pairs at {words} words")
    torch.cuda.synchronize()
    assert hamming_two_nn_pairs.launches == before + 1, \
        (words, before, hamming_two_nn_pairs.launches)
    out = dict(dev_ms=device_ms(lambda: hamming_two_nn_pairs(*args)),
               call_ms=time_ms(lambda: hamming_two_nn_pairs(*args)),
               plain_ms=time_ms(lambda: hamming_two_nn_pairs_plain(*args),
                                reps=3))
    out.update(k4_bound(args, valid))
    return out


# Phase 6b: the descriptor word counts it drives on the ring's shape (5
# is not a multiple of 4: a part stage of depth), and the device ms of the
# popcount kernel that K4 replaced at 1-32 words, at the same shape on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md's earlier rows).
CHUNKED_WORDS = (1, 4, 5, 13, 16, 32)
POPCOUNT_MS = {1: 0.4645, 4: 1.1277, 13: 4.0138, 16: 4.4189, 32: 10.2532}
# Past the 32-bit key: a column past 16 bits (K = 70000, the JAX CLI's
# `--num-features 70000`), a distance past 16 bits (2048 and 4096 words at
# K = 512), and 363 images of K = 128: 65703 pairs, past grid.y's 65535.
WIDE_K = 70000
WIDE_WORDS = (2048, 4096)
MANY_IMAGES = 363


def _word_stack(dev, words: int, k: int = 4000, n: int = 8, seed: int = 0):
    """n images of K random `words`-word descriptors, images 1..n-1 near
    copies of image 0 (each bit flipped with probability 0.05, so the
    nearest distances are small and varied), 90% valid; every pair i < j."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n, k, words), dtype=np.uint64).astype(
        np.uint32)
    bits = rng.random((n - 1, k, words, 32)) < 0.05
    flips = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)
    d[1:] = d[0] ^ flips
    valid = rng.random((n, k)) > 0.1
    iu, ju = np.triu_indices(n, 1)
    return (torch.as_tensor(d.view(np.int32), device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(iu, dtype=torch.int32, device=dev),
            torch.as_tensor(ju, dtype=torch.int32, device=dev))


def _runs_stack(dev, words: int, k: int = 4000, n: int = 8, seed: int = 0,
                run: int = 84, block: int = 500):
    """`_word_stack` with the valid columns in runs, as ORB's per-level
    top-k leaves them on mosaic100 (~670 valid of 4000): per image the
    first `run` columns of each `block`-column block."""
    desc, _, iu, ju = _word_stack(dev, words, k, n, seed)
    valid = (torch.arange(k, device=dev) % block < run).expand(n, k)
    return desc, valid.contiguous(), iu, ju


def _with_words(feats, words: int):
    """The features with their 8-word descriptors cut to the first `words`
    words, or widened by zero words, which change no distance."""
    import dataclasses
    desc = feats.desc
    if words <= desc.shape[2]:
        desc = desc[..., :words]
    else:
        desc = torch.cat([desc, desc.new_zeros(desc.shape[:2] + (
            words - desc.shape[2],))], dim=-1)
    return dataclasses.replace(feats, desc=desc.contiguous())


MATCH_FIELDS = ("ii", "jj", "a_idx", "b_idx", "valid", "inlier", "h",
                "num_inliers", "confidence", "num_matches")


def check_k4_chunked(dev, feats, cfg):
    """Phase 6b: K4 at the word counts other than ORB's.  (a) At each W in
    CHUNKED_WORDS a random stack of 8 images of K = 4000 (28 pairs both
    ways), the same with its valid columns in runs (whole column tiles
    skipped) and the tie stack against the plain version, indices equal
    and distances exact (W = 5 is not a multiple of 4: a part stage).
    (b) match_all_pairs, as the default stitch calls it, on the default
    path's ORB features with their descriptors widened by zero words to W
    (12, 13, 16, 32) or cut to the first W words (1, 4, 5), each call with
    K4's count set to 0 just before it and read just after: one launch; at
    W >= 8 the match tables, inlier counts, homographies and confidences
    equal the 8-word call's with the same key.  (c) K4 at each W on
    those descriptors against its plain version, with its device, call
    and plain ms, both bounds and its share of the tensor-core bound.
    Returns the kernel rows."""
    from image_stitching_tpu_torch.core.prng import PRNGKey
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_pairs, hamming_two_nn_pairs_plain)
    from image_stitching_tpu_torch.ops.matching import match_all_pairs
    k = feats.xy.shape[1]
    for words in CHUNKED_WORDS:
        for what, args in (
                ("random stack", _word_stack(dev, words, k, seed=words)),
                ("valid runs", _runs_stack(dev, words, k, seed=words)),
                ("tie case", _tie_stack(dev, k, words=words))):
            _k4_equal(hamming_two_nn_pairs(*args),
                      hamming_two_nn_pairs_plain(*args),
                      f"{what} at {words} words")
    torch.cuda.synchronize()
    print(f"phase 6b K4 at other widths: random stacks of 8 x K={k} (28 "
          f"pairs, both directions), the same with valid columns in runs "
          f"and the tie stack at W = {CHUNKED_WORDS} equal to the plain "
          f"version", flush=True)

    def graph(words):
        hamming_two_nn_pairs.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = match_all_pairs(_with_words(feats, words),
                            PRNGKey(cfg.seed, dev),
                            match_conf=cfg.match_conf,
                            pair_cap=cfg.num_features)
        torch.cuda.synchronize()
        return g, time.perf_counter() - t0, hamming_two_nn_pairs.launches

    base, base_s, launches8 = graph(8)
    assert launches8 == 1, launches8
    adj = range(feats.xy.shape[0] - 1)
    inliers = [int(base.num_inliers[a, a + 1]) for a in adj]
    rows = []
    for words in (12,) + CHUNKED_WORDS:
        g, wall_s, launches = graph(words)
        assert launches == 1, (words, launches)
        if words >= 8:
            for name in MATCH_FIELDS:
                assert torch.equal(getattr(g, name), getattr(base, name)), \
                    f"match_all_pairs at {words} words: {name} differs"
            same = "tables, inliers, H and confidences equal to 8 words"
        else:
            assert bool(torch.isfinite(g.h).all()), words
            same = (f"adjacent inliers "
                    f"{[int(g.num_inliers[a, a + 1]) for a in adj]}")
        if words == 12:
            continue
        args = k4_args(dev, _with_words(feats, words))
        tm = k4_times(args, feats.valid)
        share = tm["tensor_ms"] / tm["dev_ms"]
        popc = POPCOUNT_MS.get(words)
        print(f"phase 6b K4 at W = {words} ({32 * words} bits) on "
              f"DEFAULT_RING's features: match_all_pairs {wall_s * 1e3:.1f} "
              f"ms (8 words: {base_s * 1e3:.1f} ms; launches 1), {same}; "
              f"per K4 call: device {tm['dev_ms']:.4f} ms ({share:.1%} of "
              f"the tensor-core bound"
              + (f"; the popcount kernel's earlier row {popc} ms" if popc
                 else "") +
              f"), call {tm['call_ms']:.4f} ms, plain {tm['plain_ms']:.4f} "
              f"ms; bound over {tm['n_dist']:.0f} valid distances: CUDA "
              f"cores {tm['cuda_core_ms']:.4f} ms, tensor cores "
              f"{tm['tensor_ms']:.4f} ms -> {tm['bound_ms']:.4f} ms "
              f"({tm['route']})", flush=True)
        rows.append(k4_row(
            f"W = {words}", tm, words=words, launches=launches,
            launches_by_path={
                f"phase 6b match_all_pairs at {words} words": launches},
            match_all_pairs_ms=wall_s * 1e3))
    print(f"phase 6b the slice's path: match_all_pairs on DEFAULT_RING at "
          f"8, 12 and {CHUNKED_WORDS} words, one K4 launch each; adjacent "
          f"inliers at 8 words {inliers}", flush=True)
    return rows


def k4_row(what: str, tm, **extra):
    """A kernels-line row of K4 from `k4_times`-style numbers."""
    return dict(
        name=f"hamming_two_nn_pairs [K4, {what}]", route="cuda",
        source="image_stitching_tpu_torch/csrc/hamming_chunked.cu",
        replaces="image_stitching_tpu/kernels/hamming_pallas.py:178",
        max_abs_err=0.0, ms=tm["dev_ms"], device_ms=tm["dev_ms"],
        call_ms=tm["call_ms"], plain_ms=tm["plain_ms"],
        bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
        bound_route=tm["route"], bound_cuda_core_ms=tm["cuda_core_ms"],
        bound_tensor_core_ms=tm["tensor_ms"],
        tensor_core_share=tm["tensor_ms"] / tm["dev_ms"], library_ms=None,
        **extra)


def _flip_bits(rng, shape, p: float) -> np.ndarray:
    """uint32 words of `shape`, each bit set with probability p."""
    bits = rng.random(shape + (32,), dtype=np.float32) < p
    return np.packbits(bits, axis=-1, bitorder="little").view(
        "<u4")[..., 0]


def _wide_stack(dev, k: int = WIDE_K, n: int = 4, seed: int = 0,
                words: int = 8):
    """n images of K random descriptors; in images 1..n-1 columns 2 r and
    2 r + 1 hold near copies of row r of image 0 for r < K / 2 (each bit
    flipped with probability 0.05), so rows of image 0 from 32768 up find
    their nearest and second nearest past column 65535; 90% valid; every
    pair i < j."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n, k, words), dtype=np.uint64).astype(
        np.uint32)
    half = k // 2
    d[1:, :2 * half] = np.repeat(d[0, :half], 2, axis=0) ^ _flip_bits(
        rng, (n - 1, 2 * half, words), 0.05)
    valid = rng.random((n, k)) > 0.1
    iu, ju = np.triu_indices(n, 1)
    return (torch.as_tensor(d.view(np.int32), device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(iu, dtype=torch.int32, device=dev),
            torch.as_tensor(ju, dtype=torch.int32, device=dev))


def k4_plain_rows(args, rows=None, block: int = 8192):
    """The plain version's (fwd, rev) of `args` on the rows `rows` of each
    pair's A image, or on all rows by blocks of `block`: one pair,
    direction and block at a time (a whole (K, K) matrix at K = 70000
    takes 20 GB)."""
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_plain)
    desc, valid, ii, jj = args
    k = desc.shape[1]
    blocks = [rows] if rows is not None else [
        torch.arange(s, min(s + block, k), device=desc.device)
        for s in range(0, k, block)]
    sides = []
    for img_a, img_b in ((ii, jj), (jj, ii)):
        outs = []
        for a, b in zip(img_a.tolist(), img_b.tolist()):
            parts = [hamming_two_nn_plain(desc[a, r], desc[b], valid[b])
                     for r in blocks]
            outs.append([torch.cat(x) for x in zip(*parts)])
        sides.append(tuple(torch.stack(x) for x in zip(*outs)))
    return tuple(sides)


def _one_launch(args):
    """K4 on `args` with its count set to 0 just before and read just
    after; (output, launches)."""
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_pairs)
    hamming_two_nn_pairs.launches = 0
    out = hamming_two_nn_pairs(*args)
    torch.cuda.synchronize()
    return out, hamming_two_nn_pairs.launches


def check_k4_wide(dev):
    """Phase 6b, past the 32-bit key and grid.y: (a) K = 70000 at 8 words,
    4 images, 6 pairs both ways, on `_wide_stack`, the same with its valid
    columns in runs and the tie stack (its duplicates at c and c + 35000
    tie across column 65536), against the plain version on every row by
    blocks, indices equal and distances exact; (b) W = 2048 and 4096 at K
    = 512 (`_wide_stack`, 4 images, one row 32 W from a whole image),
    against the plain version; (c) 363 images of K =
    128 at 8 words, 65703 pairs in one call, against the plain version on
    256 of its pairs.  Each in one launch under the count; device, call
    and plain ms and the bound on the first stack of each.  Returns the
    kernel rows."""
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_pairs, hamming_two_nn_pairs_plain, key_bits, max_k)
    rows = []
    print(f"phase 6b K4 limit: K <= {max_k(8, dev)} at 8 words, "
          f"{max_k(4096, dev)} at 4096 (the kernel's shared-memory layout "
          f"on this device)", flush=True)

    def row(what, args, plain, dev_reps, **extra):
        fn = lambda: hamming_two_nn_pairs(*args)  # noqa: E731
        tm = dict(dev_ms=device_ms(fn, reps=dev_reps, replays=2),
                  call_ms=time_ms(fn, reps=dev_reps),
                  plain_ms=time_ms(plain, reps=1))
        tm.update(k4_bound(args, args[1]))
        k, words = args[0].shape[1], args[0].shape[2]
        print(f"phase 6b K4 {what}: {len(args[2])} pairs of K={k} at "
              f"{words} words, {key_bits(k, words)}-bit keys, one launch; "
              f"device {tm['dev_ms']:.4f} ms "
              f"({tm['tensor_ms'] / tm['dev_ms']:.1%} of the tensor-core "
              f"bound), call {tm['call_ms']:.4f} ms, plain "
              f"{tm['plain_ms']:.4f} ms; bound over {tm['n_dist']:.0f} "
              f"valid distances {tm['bound_ms']:.4f} ms ({tm['route']})",
              flush=True)
        rows.append(k4_row(what, tm, words=words, key_bits=key_bits(
            k, words), launches=1, launches_by_path={
                f"phase 6b call, {what}": 1}, **extra))

    # (a) K = 70000.
    wide = _wide_stack(dev, WIDE_K)
    for what, args in (
            ("random", wide),
            ("valid runs", (wide[0], (torch.arange(WIDE_K, device=dev) %
                                      500 < 84).expand(4, WIDE_K)
                            .contiguous(), wide[2], wide[3])),
            ("tie case", _tie_stack(dev, WIDE_K))):
        got, launches = _one_launch(args)
        assert launches == 1, launches
        want = k4_plain_rows(args)
        _k4_equal(got, want, f"K = {WIDE_K}, {what}")
        if what == "random":
            past = int((want[0][0][:, 32768:] >= 65536).sum())
            assert past > 0, "no nearest column past 65535"
        if what == "tie case":
            ties = int((want[1][1] == want[1][3]).sum())
        del got, want
    print(f"phase 6b K4 at K = {WIDE_K} (8 words, 64-bit keys): random "
          f"stack ({past} forward rows' nearest past column 65535), valid "
          f"runs and tie stack ({ties} reverse rows with d1 == d2) equal to "
          f"the plain version on every row", flush=True)
    row(f"K = {WIDE_K}", wide, lambda: k4_plain_rows(wide), 3)
    del wide
    # (b) 2048 and 4096 words; image 3 all the complement of image 2's
    # row 0, which is then 32 W (past 16 bits) from every column of it.
    for words in WIDE_WORDS:
        args = _wide_stack(dev, k=512, seed=words, words=words)
        args[0][3] = ~args[0][2, 0]
        got, launches = _one_launch(args)
        assert launches == 1, launches
        want = hamming_two_nn_pairs_plain(*args)
        _k4_equal(got, want, f"{words} words")
        assert float(want[0][1][5, 0]) == float(want[0][3][5, 0]) == \
            32 * words, "no distance past 16 bits"
        row(f"W = {words}", args,
            lambda: hamming_two_nn_pairs_plain(*args), 5)
    # (c) 65703 pairs.
    args = _word_stack(dev, 8, k=128, n=MANY_IMAGES, seed=3)
    n_pairs = len(args[2])
    assert n_pairs == 65703 > 65535, n_pairs
    got, launches = _one_launch(args)
    assert launches == 1, launches
    pick = torch.as_tensor(np.r_[0:64, n_pairs - 64:n_pairs, np.random.
                                 default_rng(0).choice(n_pairs, 128, False)],
                           device=dev)
    _k4_equal(tuple(tuple(x[pick] for x in side) for side in got),
              hamming_two_nn_pairs_plain(args[0], args[1], args[2][pick],
                                         args[3][pick]),
              f"{n_pairs} pairs")
    row(f"{n_pairs} pairs", args, lambda: hamming_two_nn_pairs_plain(*args),
        5)
    return rows


def check_k4(dev, feats):
    """K4 on the descriptors the default path's orb_detect_stack gave
    matching: all 28 pairs i < j, both directions, in the one call
    match_all_pairs makes; then a tie-heavy stack at the same K."""
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_pairs, hamming_two_nn_pairs_plain, pm1_rows,
        unpack_pm1)
    k = feats.xy.shape[1]
    args = k4_args(dev, feats)
    pm1_eq = torch.equal(unpack_pm1(args[0]), pm1_rows(args[0]))
    assert pm1_eq, "K4's +-1 unpack differs from pm1_rows"
    ties = _tie_stack(dev, k)
    got_t = hamming_two_nn_pairs(*ties)
    want_t = hamming_two_nn_pairs_plain(*ties)
    _k4_equal(got_t, want_t, "tie case")
    n_tied = int((want_t[0][1] == want_t[0][3]).sum())
    tm = k4_times(args, feats.valid)
    unpack_ms = device_ms(lambda: unpack_pm1(args[0]))
    print(f"phase 6 K4 hamming_two_nn_pairs: {len(args[2])} pairs of K={k}, "
          f"both directions, in one call (an unpack and a 2-NN launch), "
          f"valid per image {feats.valid.sum(-1).tolist()}, +-1 "
          f"unpack equal to pm1_rows: yes, i1/d1/d2 equal and i2 equal where "
          f"d2 < 2^30: yes; tie case (4 images, duplicated descriptors, 1 "
          f"and 0 valid columns, {n_tied} forward rows with d1 == d2): "
          f"equal; per call: device {tm['dev_ms']:.4f} ms (unpack alone "
          f"{unpack_ms:.4f}), call "
          f"{tm['call_ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms; bound "
          f"over {tm['n_dist']:.0f} valid distances: CUDA cores "
          f"{tm['cuda_core_ms']:.4f} ms, tensor cores {tm['tensor_ms']:.4f} "
          f"ms -> {tm['bound_ms']:.4f} ms ({tm['route']})", flush=True)
    row = k4_row("the ring, 8 words", tm, words=8)
    row["name"] = "hamming_two_nn_pairs"
    return row


def _k5_gates(acc_k, acc_p, nb, what: str):
    """Accumulators within 2e-3, finalized u8 panorama within 1, masks
    equal.  Returns (accumulator error, u8 error)."""
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(acc_k, acc_p))
    assert err <= 2e-3, f"K5 {what}: accumulators differ by {err} (tol 2e-3)"
    pano_k, mask_k = cf._finalize(acc_k, nb)
    pano_p, mask_p = cf._finalize(acc_p, nb)
    u8 = int((pano_k.int() - pano_p.int()).abs().max())
    assert u8 <= 1, f"K5 {what}: finalized panorama differs by {u8} (tol 1)"
    assert torch.equal(mask_k, mask_p), f"K5 {what}: finalized masks differ"
    return err, u8


# The `cuda` tests' buckets, (n_bands, ph, pw, canvas (h, w), offsets):
# 4 overlapping 96x128 rects with windows at both canvas edges, a clamped
# offset (200, 160) and an odd one (13, 5); 130 rects of 16x32, each
# overlapping the next, past the 128 images of one band launch (the last
# three clamped onto one window at the right edge, across that boundary);
# and 4 overlapping 40x56 rects at odd offsets with 0 bands, as FEATHER
# and NO compose (one band launch, no pyrDown, no next level).
K5_CASES = {
    "edge case": (3, 96, 128, (160, 200),
                  [(0, 0), (40, 24), (200, 160), (13, 5)]),
    "130 images": (1, 16, 32, (40, 2064),
                   [(16 * i + i % 3, 5 * (i % 5)) for i in range(130)]),
    "0 bands": (0, 40, 56, (70, 96), [(0, 0), (13, 5), (37, 22), (3, 29)]),
}


def k5_case(dev, what):
    """One call on a K5_CASES bucket against the plain version, and its
    kernel launches (CUDA graph nodes, at most 2 n_bands + 1).  Returns
    (accumulator error, u8 error, launches)."""
    from image_stitching_tpu_torch.kernels.multiband import (
        pyramid_accumulate, pyramid_accumulate_plain)
    nb, ph, pw, (ch, cw), offs = K5_CASES[what]
    rng = np.random.default_rng(8)
    warped = torch.as_tensor(rng.uniform(0, 255, (len(offs), 3, ph, pw))
                             .astype(np.float32), device=dev)
    weight = torch.as_tensor((rng.random((len(offs), ph, pw)) > 0.3)
                             .astype(np.float32), device=dev)
    accs = [[torch.zeros((4, ch >> b, cw >> b), device=dev)
             for b in range(nb + 1)] for _ in range(3)]
    pyramid_accumulate(warped, weight, offs, accs[0], nb)
    pyramid_accumulate_plain(warped, weight, offs, accs[1], nb)
    err, u8 = _k5_gates(accs[0], accs[1], nb, what)
    n_launch = kernel_launches(
        lambda: pyramid_accumulate(warped, weight, offs, accs[2], nb))
    assert n_launch <= 2 * nb + 1, \
        f"K5 {what}: {n_launch} kernel launches (most {2 * nb + 1})"
    return err, u8, n_launch


def check_k5(dev, compose_call):
    """K5 on the buckets of compose rects of a default-path stitch, one call
    per bucket: compose_buckets (the compose's own samples, stacked per
    bucket) on the arguments that stitch handed fused_compose; then the
    K5_CASES buckets.  The kernel launches of a call are the kernel nodes
    of a CUDA graph of the calls, at most 2 n_bands + 1 per call.  K2 is
    held against its plain version on the (src, sx, sy) of the same
    samples."""
    from image_stitching_tpu_torch.kernels.multiband import (
        band_offsets, pyramid_accumulate, pyramid_accumulate_plain)
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    args = compose_call[0]
    g = cf.compose_rects(args[4], args[5], args[10], args[11])
    with Recorder(cf, "warp_bilinear") as k2_rec:
        buckets = list(cf.compose_buckets(*args[:10], g))
    k2_calls = [call[0] for call in k2_rec.calls["warp_bilinear"]]
    k2_err = k2_max_diff(k2_calls)
    nb = g.n_bands

    def fresh():
        return [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b),
                            device=dev) for b in range(nb + 1)]
    acc_k, acc_p = fresh(), fresh()
    for warped, weight, offs in buckets:
        pyramid_accumulate(warped, weight, offs, acc_k, nb)
        pyramid_accumulate_plain(warped, weight, offs, acc_p, nb)
    err, u8 = _k5_gates(acc_k, acc_p, nb, "default path")
    cases = {what: k5_case(dev, what) for what in K5_CASES}
    scratch = fresh()

    def run(fn):
        for warped, weight, offs in buckets:
            fn(warped, weight, offs, scratch, nb)
    n_calls = len(buckets)
    n_rects = sum(w.shape[0] for w, _, _ in buckets)
    dev_ms = device_ms(lambda: run(pyramid_accumulate)) / n_calls
    kernels_per_call = kernel_launches(
        lambda: run(pyramid_accumulate)) / n_calls
    assert kernels_per_call <= 2 * nb + 1, \
        f"K5: {kernels_per_call} kernel launches a call (most {2 * nb + 1})"
    call_ms = time_ms(lambda: run(pyramid_accumulate)) / n_calls
    plain_ms = time_ms(lambda: run(pyramid_accumulate_plain)) / n_calls
    # Bytes of a call: its N rects (3 planes + weight) in, and the union of
    # their windows in every band, 4 channels, read and written once.  The
    # per-rect count (each rect plus its own windows read and written, as
    # a call per rect moves them) is kept beside it, in the text only.
    # Operations: 5x5 taps of the 4-channel pyrDown per level, 3x3 nonzero
    # pyrUp taps of 3 channels, subtract, weight and add per band pixel.
    n_bytes = n_ops = rect_bytes = 0.0
    union_px = [0] * (nb + 1)
    for warped, weight, offs in buckets:
        n, ph, pw = weight.shape
        n_bytes += 16 * n * ph * pw
        rect_bytes += n * (16 * ph * pw + sum(2 * 16 * (ph >> b) * (pw >> b)
                                              for b in range(nb + 1)))
        n_ops += n * (sum(4 * 50 * (ph >> b) * (pw >> b)
                          for b in range(1, nb + 1)) +
                      sum((3 * 18 + 12) * (ph >> b) * (pw >> b)
                          for b in range(nb + 1)))
        for b in range(nb + 1):
            cover = np.zeros(tuple(acc_k[b].shape[1:]), bool)
            for off in offs:
                oy, ox = band_offsets(off, acc_k, ph, pw)[b]
                cover[oy:oy + (ph >> b), ox:ox + (pw >> b)] = True
            union_px[b] += int(cover.sum())
    n_bytes += 2 * 16 * sum(union_px)
    bound_ms, bound_by = bound(n_bytes / n_calls, n_ops / n_calls)
    rect_bound_ms, _ = bound(rect_bytes / n_rects, n_ops / n_rects)
    print(f"phase 7 K5 pyramid_accumulate: {n_rects} compose rects of the "
          f"default path in {n_calls} call(s), one per bucket, canvas "
          f"{g.canvas} ({g.canvas_h}x{g.canvas_w} padded, {nb} bands), "
          f"buckets {[tuple(w.shape) for w, _, _ in buckets]}, gains "
          f"{type(args[9]).__name__ if args[9] else None}, accumulators max "
          f"|diff| {err:.3g} (tol 2e-3), finalized u8 max |diff| {u8} (tol "
          f"1), masks equal; "
          + "; ".join(f"{what} ({len(K5_CASES[what][4])} rects "
                      f"{K5_CASES[what][1]}x{K5_CASES[what][2]}, "
                      f"{K5_CASES[what][0]} bands, canvas "
                      f"{K5_CASES[what][3]}): accumulators {e:.3g}, u8 {u}, "
                      f"masks equal, {k} kernel launches"
                      for what, (e, u, k) in cases.items())
          + f"; per call: {kernels_per_call:g} kernel launches (CUDA graph "
          f"nodes), kernel device {dev_ms:.4f} "
          f"ms ({dev_ms * n_calls / n_rects:.4f} ms a rect), call "
          f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}; union of the windows per band {union_px} px, "
          f"{n_bytes / n_calls:.0f} bytes; {bound_ms / dev_ms:.1%} of it "
          f"reached); per-rect count (each rect with its own windows) "
          f"{rect_bound_ms:.4f} ms a rect, "
          f"{rect_bound_ms * n_rects:.4f} ms the {n_rects} rects; K2 on the "
          f"same {len(k2_calls)} rects' samples, source "
          f"{tuple(k2_calls[0][0].shape)}: max |diff| {k2_err:.3g} "
          f"(atol 1e-4)", flush=True)
    return dict(name="pyramid_accumulate", route="cuda",
                source="image_stitching_tpu_torch/csrc/multiband.cu",
                replaces="image_stitching_tpu/kernels/multiband_pallas.py:177",
                max_abs_err=max([err] + [e for e, _, _ in cases.values()]),
                ms=dev_ms, device_ms=dev_ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, rects_per_call=n_rects /
                n_calls, kernel_launches_per_call=kernels_per_call,
                device_ms_per_rect=dev_ms * n_calls / n_rects,
                buckets=n_calls)


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


def _pil_luma(path, num8: int) -> np.ndarray:
    """PIL's luma-only decode of a JPEG at DCT scale num8/8 (draft)."""
    from PIL import Image
    with Image.open(path) as im:
        w, h = im.size
        im.draft("L", (w * num8 // 8, h * num8 // 8))
        return np.asarray(im.convert("L"))


# The draws of `prng_draws` (a stitch's worth: DEFAULT_RING's 28 pairs,
# rig37's 666) and a handful of their uint32 words as jax.random gives
# them (pinned from jax by tests/test_torch_prng.py): (draw, index, word).
PRNG_SPLITS = (28, 666)
PRNG_GOLDEN = (
    ("split_28", (27, 0), 55715830), ("split_28", (27, 1), 3256168517),
    ("split_666", (665, 0), 3129506635), ("split_666", (665, 1), 4115858365),
    ("hyp_28", (0, 0, 0), 1062707686), ("hyp_28", (27, 511, 3), 1062774190),
    ("score_28", (13, 1023), 1053940244),
    ("hyp_666", (665, 0, 1), 1059984036),
    ("score_666", (400, 7), 1048466000))
# The JAX package's stitch of DEFAULT_RING under StitchConfig() on the CPU
# (`tools/ring_reference_jax.py`), which phase 9b holds its stitch to.
RING_REFERENCE = os.path.join(ROOT, "tests", "data",
                              "ring_reference_jax.json")


def prng_draws(dev):
    """A stitch's worth of RANSAC draws on `dev` (`core/prng.py`): for n
    in PRNG_SPLITS, the pair keys split(PRNGKey(0), n), the hypothesis
    uniforms (512, 4) under each key and the scoring uniforms (1024,)
    under fold_in(key, 1), as `ops/ransac.py` draws them."""
    from image_stitching_tpu_torch.core import prng
    out = {}
    for num in PRNG_SPLITS:
        keys = prng.split(prng.PRNGKey(0, dev), num)
        out[f"split_{num}"] = keys
        out[f"hyp_{num}"] = prng.uniform(keys, (512, 4))
        out[f"score_{num}"] = prng.uniform(prng.fold_in(keys, 1), (1024,))
    return out


def check_prng_golden(draws) -> int:
    """Hold `prng_draws`' words to PRNG_GOLDEN; returns the count held."""
    for name, index, word in PRNG_GOLDEN:
        x = draws[name][index]
        got = (int(x.view(torch.int32).item()) & 0xFFFFFFFF
               if x.is_floating_point() else int(x.item()))
        assert got == word, f"{name}{index}: {got}, jax.random's {word}"
    return len(PRNG_GOLDEN)


def run_phase1b(dev, smi):
    """Phase 1b, RANSAC's draws: `prng_draws` on the card equal the same
    draws on the CPU bit for bit, and the PRNG_GOLDEN words; the device
    ms of one threefry call at phase 9b's shapes (the 28 pair keys'
    uniforms (512, 4), and (1024,) under fold_in) by `device_ms`, with
    its kernel launches (`kernel_launches`), call ms and the CPU's ms."""
    from image_stitching_tpu_torch.core import prng
    got, want = prng_draws(dev), prng_draws(torch.device("cpu"))
    for name in want:
        assert got[name].device.type == "cuda", name
        assert torch.equal(got[name].cpu(), want[name]), \
            f"{name}: the card's draws differ from the CPU's"
    held = check_prng_golden(got)
    keys = got["split_28"]
    folded = prng.fold_in(keys, 1)
    rows = []
    for what, key, shape in (("(28, 512, 4)", keys, (512, 4)),
                             ("(28, 1024) under fold_in", folded, (1024,))):
        fn = lambda key=key, shape=shape: prng.uniform(key, shape)  # noqa
        cpu_key = key.cpu()
        t0 = time.perf_counter()
        for _ in range(5):
            prng.uniform(cpu_key, shape)
        cpu_ms = (time.perf_counter() - t0) / 5 * 1e3
        rows.append(f"uniform {what}: device {device_ms(fn):.4f} ms in "
                    f"{kernel_launches(fn)} launches, call "
                    f"{time_ms(fn):.4f} ms, CPU {cpu_ms:.4f} ms")
    print(f"phase 1b RANSAC draws (core/prng.py, threefry-2x32): "
          f"split(PRNGKey(0), n) for n = {PRNG_SPLITS}, uniform (512, 4) "
          f"and (1024,) under fold_in: the card's equal the CPU's bit for "
          f"bit, "
          f"{held} words equal jax.random's; " + "; ".join(rows)
          + f"; card '{smi}'", flush=True)


def ring_reference_check(res, graph, caps_default):
    """Phase 9b against the JAX package's stitch of the same ring on the
    CPU (RING_REFERENCE): kept indices equal, focal within rtol 1e-3,
    adjacent relative rotations within 0.05 degrees (the CPU e2e tests'
    gates); the captures' SHA-256 and each pair's n_inliers and n_matches
    against the reference's, reported.  Returns the report line."""
    with open(RING_REFERENCE) as f:
        ref = json.load(f)
    same_files = all(
        hashlib.sha256(open(os.path.join(caps_default, name), "rb").read())
        .hexdigest() == digest for name, digest in
        ref["capture_sha256"].items())
    assert res.kept_indices == ref["kept_indices"], \
        (res.kept_indices, ref["kept_indices"])
    cams = res.cameras.numpy()
    focal_ref = np.asarray(ref["focal"])
    focal_rel = float(np.max(np.abs(cams["focal"] - focal_ref) / focal_ref))
    assert focal_rel <= 1e-3, (cams["focal"], focal_ref)
    r_ref = np.asarray(ref["R"])
    angles = [rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                               r_ref[a + 1] @ r_ref[a].T)
              for a in range(len(r_ref) - 1)]
    assert max(angles) <= 0.05, angles
    pairs = [(i, j) for i, j in ref["pairs"]]
    ninl = [int(graph.num_inliers[i, j]) for i, j in pairs]
    nm = [int(graph.num_matches[i, j]) for i, j in pairs]
    inl_diff = [a - b for a, b in zip(ninl, ref["num_inliers"])]
    return (f"against the JAX package's stitch on the CPU (jax "
            f"{ref['jax']}, {os.path.relpath(RING_REFERENCE, ROOT)}): "
            f"captures "
            f"{'identical' if same_files else 'NOT identical'} by SHA-256; "
            f"kept {res.kept_indices} equal; focal within "
            f"{focal_rel:.3g} (<= 1e-3); adjacent relative rotations "
            f"within {max(angles):.4f} deg (<= 0.05); n_matches equal on "
            f"{sum(a == b for a, b in zip(nm, ref['num_matches']))}/"
            f"{len(pairs)} pairs, n_inliers on "
            f"{sum(d == 0 for d in inl_diff)}/{len(pairs)} (port - "
            f"reference {inl_diff})")


def check_ingest(dev, paths, seam_hw):
    """Phase 9a: the raw 4:2:0 route on the captures, its planes against
    PIL's decodes, and the card's fast_prep against the CPU's."""
    from PIL import Image
    from image_stitching_tpu_torch.pipeline import ingest
    fi = ingest.start_fast_ingest(paths, False, True, 1.0, 1.0, device=dev)
    assert fi is not None and fi.raw_yuv and fi.raw_num8 == 8, \
        "fast ingest did not take the raw 4:2:0 route at num8 8"
    pinned = sum(isinstance(b, torch.Tensor) and b.is_pinned()
                 for b in fi.session._buffers)
    assert pinned == len(paths) or dev.type != "cuda", \
        f"{pinned} pinned host buffers"
    t0 = time.perf_counter()
    _, raw = fi.upload()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    y, cb, cr = ingest._unpack_planes(raw, fi.raw_layout)
    rgb = ingest.yuv420_to_rgb_exact(y, cb, cr).cpu().numpy()
    y_host = y.cpu().numpy()
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
        assert np.array_equal(rgb[i], want), \
            f"{os.path.basename(p)}: device RGB differs from PIL's decode"
        assert np.array_equal(y_host[i], _pil_luma(p, 8)), \
            f"{os.path.basename(p)}: Y plane differs from PIL's luma decode"
    del rgb, y_host
    half = ingest.start_fast_ingest(paths, False, True, 0.5, 0.3, device=dev)
    assert half is not None and half.raw_yuv and half.raw_num8 == 4
    y4 = ingest._unpack_planes(half.upload()[1], half.raw_layout)[0]
    y4 = y4.cpu().numpy()
    for i, p in enumerate(paths):
        assert np.array_equal(y4[i], _pil_luma(p, 4)), \
            f"{os.path.basename(p)}: num8-4 Y plane differs from PIL's"
    hw = tuple(y4.shape[1:])
    del y4

    def prep(stack):
        return ingest.fast_prep(fi, None, stack, False, (H, W), seam_hw)
    out_d = prep(raw)
    out_c = prep(raw.cpu())
    for what, a, b in zip(("gray_work", "rgb"), out_d[:2], out_c[:2]):
        assert torch.equal(a.cpu(), b), f"fast_prep {what}: card != CPU"
    seam_err = int((out_d[2].cpu().int() - out_c[2].int()).abs().max())
    assert seam_err <= 1, f"fast_prep seam stack: card - CPU = {seam_err}"
    del out_d, out_c
    prep_ms = time_ms(lambda: prep(raw), reps=5)
    # Bytes fast_prep must move: the packed planes in; the work gray, the
    # oriented RGB and the seam stack out.
    n_bytes = raw.numel() + len(paths) * (H * W * 4 + seam_hw[0] *
                                          seam_hw[1] * 3)
    print(f"phase 9a fast ingest: raw 4:2:0 route on all {len(paths)} "
          f"files, num8 8, {pinned} pinned host buffers, planes "
          f"{tuple(raw.shape)} u8 decoded and uploaded in {upload_s:.4f} s "
          f"(2 decode threads, host of {os.cpu_count()} CPUs); device RGB "
          f"equal to PIL's RGB decode and Y equal to PIL's luma decode on "
          f"every file; num8 4: Y {hw} equal to PIL's half-size luma decode "
          f"on every file; fast_prep card == CPU (gray, oriented RGB; seam "
          f"within {seam_err}), {prep_ms:.4f} ms a call (CUDA events, "
          f"device-bound), bytes bound {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} "
          f"ms ({n_bytes} bytes)", flush=True)
    return prep_ms


def write_e2e_rings(caps, caps_default, caps_plain, workers: int,
                    caps_noisy=None):
    """E2E_RING into `caps` and DEFAULT_RING into `caps_default` (and
    without EXIF into `caps_plain`), the files `write_ring_dir` writes for
    each: the two share geometry and seed, so each view is rendered once
    and takes `write_ring_dir`'s noise (`ring_view_noise`) at sigma 4 and
    8; and, when given, into `caps_noisy` at DETECTOR_RING_SIGMA.
    Returns the ground truth (K float64, [R float64])."""
    import multiprocessing as mp
    from image_stitching_tpu_torch.data.synth import (_render_args,
                                                      ring_geometry,
                                                      ring_view_noise,
                                                      write_capture_dir)
    assert {k: v for k, v in DEFAULT_RING.items() if k != "noise_sigma"} \
        == E2E_RING
    g = E2E_RING
    k, rs = ring_geometry(g["n_images"], g["hw"], g["fov_deg"],
                          g["overlap_ratio"])
    with mp.get_context("spawn").Pool(workers) as pool:
        views = pool.map(_render_args,
                         [(k, r, g["hw"], g["seed"]) for r in rs])
    rs32 = np.stack([r.astype(np.float32) for r in rs])
    dirs = [(caps, 4.0), (caps_default, DEFAULT_RING["noise_sigma"])]
    if caps_noisy is not None:
        dirs.append((caps_noisy, DETECTOR_RING_SIGMA))
    for directory, sigma in dirs:
        images = [ring_view_noise(v, i, sigma) for i, v in enumerate(views)]
        write_capture_dir(directory, images, k.astype(np.float32), rs32)
        if directory == caps_default:
            write_capture_dir(caps_plain, images, k.astype(np.float32), rs32,
                              with_exif=False)
    return k.astype(np.float64), [r.astype(np.float64) for r in rs32]


def stage_table(columns) -> str:
    """Stage times (s) of several runs side by side, one line a stage."""
    names = list(dict.fromkeys(k for _, times in columns for k in times))
    head = " | ".join(label for label, _ in columns)
    rows = [f"  {name}: " + " | ".join(
        f"{times[name]:.4f}" if name in times else "-"
        for _, times in columns) for name in names]
    return f"stage (s): {head}\n" + "\n".join(rows)


def stitch_run(stitch, caps, cfg, counters, recorder=None, output=""):
    """One timed stitch() with every kernel's count set to 0 just before
    it and read just after."""
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if recorder is None:
        res = stitch(caps, cfg, output=output, device="cuda")
    else:
        with recorder:
            res = stitch(caps, cfg, output=output, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {fn.__name__: fn.launches for fn in counters}


def e2e_gates(res, k_true, rs_true, launches, names, n_images=N_IMAGES,
              hw=(H, W)):
    pano = res.panorama
    assert pano.ndim == 3 and pano.shape[2] == 3, tuple(pano.shape)
    assert bool(torch.isfinite(pano).all()), "non-finite panorama"
    assert res.kept_indices == list(range(n_images)), res.kept_indices
    err = reproj_err_px(res.cameras, res.kept_indices, k_true, rs_true,
                        res.work_scale, hw)
    assert err <= 1.0, f"reprojection error {err:.4f} px > 1 px"
    coverage = float(res.mask.float().mean())
    assert coverage > 0.9, f"mask coverage {coverage:.4f}"
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    stages = ", ".join(f"{k}={v:.4f}s" for k, v in res.stage_times.items())
    return err, coverage, stages


# Phase 10's configurations, as the JAX package's bench.py makes them.
CYL4 = dict(n_images=4, hw=(1080, 1920), fov_deg=55.0, overlap_ratio=0.45)
# bench.py times cyl4 on seeds 11, 13, 14 and vga_pair on 101-105; the
# smoke keeps seed 11 and 101-103 (phase 12 took the time the others had).
CYL4_SEEDS = (12, 11)               # bench.py:250-264; 12 is the warm-up
VGA = dict(n_images=2, hw=(480, 640), fov_deg=55.0, overlap_ratio=0.5)
VGA_SEEDS = tuple(range(100, 104))  # bench.py:198-212; 100 the warm-up
SEAM_FINDERS = ("voronoi", "gc_color", "gc_colorgrad")


def render_bench_dirs(root: str, workers: int):
    """Phase 10's capture sets by the port's make_ring_captures and
    write_capture_dir, as bench.py makes them, every view rendered in one
    process pool: {(name, seed): (directory, K, [R])}."""
    import multiprocessing as mp
    from image_stitching_tpu_torch.data.synth import (make_ring_captures,
                                                      write_capture_dir)
    jobs = ([("cyl4", s, CYL4) for s in CYL4_SEEDS] +
            [("vga", s, VGA) for s in VGA_SEEDS])

    def one(job):
        name, seed, geo = job
        images, k, rs = make_ring_captures(seed=seed, pool=pool, **geo)
        d = os.path.join(root, f"{name}_s{seed}")
        write_capture_dir(d, images, k, rs)
        return (name, seed), (d, np.asarray(k, np.float64),
                              np.asarray(rs, np.float64))
    with mp.get_context("spawn").Pool(workers) as pool, \
            concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(one, jobs))


def compose_k2_calls(compose_call):
    """The (src, sx, sy) K2 calls of a recorded fused_compose call, made
    again by the compose's own samples (compose_buckets)."""
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    args = compose_call[0]
    g = cf.compose_rects(args[4], args[5], args[10], args[11])
    with Recorder(cf, "warp_bilinear") as rec:
        for _ in cf.compose_buckets(*args[:10], g):
            pass
    return [call[0] for call in rec.calls["warp_bilinear"]], g


def huge_plane_calls(dev, src):
    """Two 576x1024 rects of plane-projection maps whose valid coordinates
    reach past +-2^31, NaN-free: a camera yawed 80 degrees, warper scale
    1e7, the rects straddling the column where the ray depth crosses 0
    (depths of ~1e-7 there).  Returns the K2 calls and the count of such
    coordinates."""
    import math
    from image_stitching_tpu_torch.ops.warps import backward_xy_1d
    f, th, scale = 1000.0, math.radians(80.0), 1e7
    k = np.array([[f, 0, 960], [0, f, 540], [0, 0, 1]], np.float32)
    r = np.array([[math.cos(th), 0, math.sin(th)], [0, 1, 0],
                  [-math.sin(th), 0, math.cos(th)]], np.float32)
    krinv = k.astype(np.float64) @ r.T.astype(np.float64)
    u_cross = float(round(-krinv[2, 2] / krinv[2, 0] * scale))
    calls, n_big = [], 0
    for v0 in (-288.0, 100.0):
        us = torch.arange(-512, 512, dtype=torch.float32, device=dev) + \
            u_cross
        vs = torch.arange(576, dtype=torch.float32, device=dev) + v0
        sx, sy, valid = backward_xy_1d(
            "plane", us, vs, torch.as_tensor(k, device=dev),
            torch.as_tensor(r, device=dev), scale)
        assert bool(torch.isfinite(sx).all() and torch.isfinite(sy).all())
        n_big += int((((sx.abs() > 2.0 ** 31) | (sy.abs() > 2.0 ** 31))
                      & valid).sum())
        calls.append((src, sx.contiguous(), sy.contiguous()))
    assert n_big > 0, "no plane-map coordinate past 2^31"
    return calls, n_big


def check_k2_more(dev, stitch, caps, work):
    """Phase 3 on more maps: the cyl4 warm-up stitch (seed 12), K2 against
    its plain version on that stitch's compose rects (cylindrical maps)
    and on a plane-projection rect set with coordinates past +-2^31.
    Returns the cylindrical rects' device ms per rect."""
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.kernels.warp_gather import warp_bilinear
    from image_stitching_tpu_torch.pipeline import stitcher
    cfg = StitchConfig(num_features=1500, warp_type="cylindrical",
                       checkpoint_dir=work)
    rec = Recorder(stitcher, "fused_compose")
    with rec:
        stitch(caps[("cyl4", CYL4_SEEDS[0])][0], cfg, output="",
               device="cuda")
    calls, g = compose_k2_calls(rec.calls["fused_compose"][0])
    err = k2_max_diff(calls)
    dev_ms = device_ms(lambda: [warp_bilinear(*c) for c in calls]) / \
        len(calls)
    bound_ms, bound_by = k2_bound(calls)
    plane, n_big = huge_plane_calls(dev, calls[0][0])
    err_p = k2_max_diff(plane)
    print(f"phase 3 K2 on cylindrical maps: cyl4 warm-up stitch (seed "
          f"{CYL4_SEEDS[0]}), {len(calls)} compose rects "
          f"{sorted((3,) + k for k in g.buckets)}, source "
          f"{tuple(calls[0][0].shape)}, max |diff| {err:.3g} (atol 1e-4), "
          f"kernel device {dev_ms:.4f} ms a rect, bound {bound_ms:.4f} ms "
          f"({bound_by}, {bound_ms / dev_ms:.1%} of it reached); plane "
          f"maps past 2^31: {len(plane)} rects 576x1024, {n_big} valid "
          f"coordinates past +-2^31, max |diff| {err_p:.3g}", flush=True)
    return dev_ms


def k5_union_bytes(shape, offs, accs, nb) -> int:
    """Phase 7's bytes of one K5 call on n rects of (ph, pw) at `offs`:
    the rects in, the union of their windows in every band read and
    written once."""
    from image_stitching_tpu_torch.kernels.multiband import band_offsets
    n, ph, pw = shape
    n_bytes = 16 * n * ph * pw
    for b in range(nb + 1):
        cover = np.zeros(tuple(accs[b].shape[1:]), bool)
        for off in offs:
            oy, ox = band_offsets(off, accs, ph, pw)[b]
            cover[oy:oy + (ph >> b), ox:ox + (pw >> b)] = True
        n_bytes += 2 * 16 * int(cover.sum())
    return n_bytes


def k5_compose_check(dev, compose_call, what: str, plain: bool = False):
    """K5 on the buckets of a recorded fused_compose call, one call per
    bucket, against its plain version under phase 7's gates; kernel
    launches per call (CUDA graph nodes, at most 2 n_bands + 1) and device
    ms per call; with `plain`, also the call ms and the plain version's ms
    per call."""
    from image_stitching_tpu_torch.kernels.multiband import (
        pyramid_accumulate, pyramid_accumulate_plain)
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    args = compose_call[0]
    g = cf.compose_rects(args[4], args[5], args[10], args[11])
    buckets = list(cf.compose_buckets(*args[:10], g))
    nb = g.n_bands

    def fresh():
        return [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b),
                            device=dev) for b in range(nb + 1)]
    acc_k, acc_p, scratch = fresh(), fresh(), fresh()
    for warped, weight, offs in buckets:
        pyramid_accumulate(warped, weight, offs, acc_k, nb)
        pyramid_accumulate_plain(warped, weight, offs, acc_p, nb)
    err, u8 = _k5_gates(acc_k, acc_p, nb, what)

    def run():
        for warped, weight, offs in buckets:
            pyramid_accumulate(warped, weight, offs, scratch, nb)
    per_call = kernel_launches(run) / len(buckets)
    assert per_call <= 2 * nb + 1, f"K5 {what}: {per_call} launches a call"
    n_bytes = sum(k5_union_bytes(weight.shape, offs, scratch, nb)
                  for _, weight, offs in buckets)
    out = dict(n_bands=nb, buckets=[tuple(w.shape) for w, _, _ in buckets],
               err=err, u8=u8, launches_per_call=per_call,
               accs=(g.canvas_h, g.canvas_w),
               device_ms=device_ms(run) / len(buckets),
               bound_ms=n_bytes / len(buckets) / HBM_BYTES_PER_S * 1e3,
               feather_sharpness=g.feather_sharpness)
    if plain:
        bounds = [k5_chunk_bound(warped, offs, scratch, nb)
                  for warped, _, offs in buckets]
        out["bound_ms"] = sum(ms for ms, _ in bounds) / len(buckets)
        out["bound_by"] = max(bounds)[1]
        out["call_ms"] = time_ms(run, reps=5) / len(buckets)
        out["plain_ms"] = time_ms(lambda: [pyramid_accumulate_plain(
            warped, weight, offs, scratch, nb)
            for warped, weight, offs in buckets], reps=1) / len(buckets)
    return out


def resume_gates(res, base, ba_cams, ck_dir, corners, base_corners,
                 mean_tol):
    """Phase 10d: a stitch resumed from phase 9b's checkpoint against 9b:
    kept indices equal; the checkpoint's cameras equal to 9b's bundle
    adjustment output within the 6 significant digits of the text format;
    focals equal after it; on the canvas both cover (the panoramas placed
    by their compose ROIs' corners, which the rounding may move by a
    pixel) the masks equal outside a 1-pixel band of 9b's mask edge, and,
    unless mean_tol is None, the panorama within mean |diff| mean_tol of
    9b's on their common mask.  Returns (camera rel error, mean |diff|,
    mask pixels differing, canvas origin shift (x, y))."""
    from image_stitching_tpu_torch.core import persistence
    assert res.kept_indices == base.kept_indices, \
        (res.kept_indices, base.kept_indices)
    assert persistence.deserialize_indices(ck_dir) == base.kept_indices
    saved = persistence.deserialize_camera_params(ck_dir).numpy()
    want = ba_cams.numpy()
    cam_err = 0.0
    for name in ("focal", "aspect", "ppx", "ppy", "R", "t"):
        a, b = saved[name].astype(np.float64), want[name].astype(np.float64)
        cam_err = max(cam_err, float((np.abs(a - b) /
                                      (np.abs(b) + 1e-6)).max()))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                   err_msg=f"checkpoint {name}")
    np.testing.assert_allclose(res.cameras.numpy()["focal"],
                               base.cameras.numpy()["focal"], rtol=1e-5)
    oa = (min(c[0] for c in corners), min(c[1] for c in corners))
    ob = (min(c[0] for c in base_corners), min(c[1] for c in base_corners))
    (ha, wa), (hb, wb) = res.panorama.shape[:2], base.panorama.shape[:2]
    assert max(abs(oa[0] - ob[0]), abs(oa[1] - ob[1]), abs(ha - hb),
               abs(wa - wb)) <= 2, (oa, ob, (ha, wa), (hb, wb))
    x0, y0 = max(oa[0], ob[0]), max(oa[1], ob[1])
    x1, y1 = min(oa[0] + wa, ob[0] + wb), min(oa[1] + ha, ob[1] + hb)

    def crop(t, o):
        return t[y0 - o[1]:y1 - o[1], x0 - o[0]:x1 - o[0]]
    pa, pb = crop(res.panorama, oa), crop(base.panorama, ob)
    ma, mb = crop(res.mask, oa), crop(base.mask, ob)
    both = ma & mb
    mean_diff = float((pa - pb).abs()[both].mean())
    assert mean_tol is None or mean_diff <= mean_tol, \
        f"resumed panorama mean |diff| {mean_diff} (tol {mean_tol})"
    mf = mb[None, None].float()
    grown = torch.nn.functional.max_pool2d(mf, 3, 1, 1)[0, 0] > 0
    shrunk = -torch.nn.functional.max_pool2d(-mf, 3, 1, 1)[0, 0] > 0
    band = grown & ~shrunk
    differ = ma ^ mb
    assert not bool((differ & ~band).any()), "masks differ off the edge band"
    return cam_err, mean_diff, int(differ.sum()), (oa[0] - ob[0],
                                                   oa[1] - ob[1])


def run_phase10(stitch, stitcher, counters, names, caps, caps_default,
                k_true, rs_true, base_9b, wall_9b, ba_9b, corners_9b, ck9b,
                work, smi, dev):
    """Phase 10, the configurations this slice adds, in the working
    directory `work` (their checkpoints go to "."): (a) cyl4, (b)
    vga_pair, (c) the voronoi and graph-cut seam finders on DEFAULT_RING,
    (d) a stitch resumed from phase 9b's checkpoint, (e) one vga_pair
    stitch with profile_dir and save_graph_to.  Each stitch runs with the kernels'
    counts set to 0 just before it and read just after.  Returns the
    counts by path and K5's 0-band check on the vga_pair rects."""
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    by_path = {}

    def gated(d, k, rs, cfg, n_img, hw, rec_names=("find_seams",)):
        rec = Recorder(stitcher, *rec_names)
        res, wall, launches = stitch_run(stitch, d, cfg, counters, rec)
        err, coverage, stages = e2e_gates(res, k, rs, launches, names,
                                          n_img, hw)
        covered, cut = seam_union_gate(rec.calls["find_seams"][0])
        return res, wall, launches, err, coverage, (covered, cut), rec

    # (a) cyl4: warm-up (seed 12) in phase 3; timed on CYL4_SEEDS[1:].
    cfg = StitchConfig(num_features=1500, warp_type="cylindrical")
    mp_in = CYL4["n_images"] * CYL4["hw"][0] * CYL4["hw"][1] / 1e6
    walls, cols = {}, []
    for seed in CYL4_SEEDS[1:]:
        d, k, rs = caps[("cyl4", seed)]
        res, wall, launches, err, cov, (covered, cut), _ = gated(
            d, k, rs, cfg, CYL4["n_images"], CYL4["hw"])
        walls[seed] = wall
        cols.append((f"seed {seed}", res.stage_times))
        if seed == CYL4_SEEDS[1]:
            by_path["phase 10a"] = launches
        print(f"phase 10a cyl4 (StitchConfig(num_features=1500, "
              f"warp_type='cylindrical'), seed {seed}): kept "
              f"{len(res.kept_indices)}/{CYL4['n_images']}, work scale "
              f"{res.work_scale:.4f}, reprojection {err:.4f} px, panorama "
              f"{tuple(res.panorama.shape)}, mask {cov:.4f}, seam union = "
              f"warped union ({covered} px, {cut} px cut), launches "
              f"{launches}, wall {wall:.4f} s ({mp_in / wall:.3f} MP/s); "
              f"card '{smi}'", flush=True)
        del res
    best = min(walls, key=walls.get)
    print(f"phase 10a cyl4: walls {walls} s, best {walls[best]:.4f} s "
          f"({mp_in / walls[best]:.3f} MP/s), median "
          f"{float(np.median(list(walls.values()))):.4f} s\n"
          + stage_table(cols), flush=True)

    # (b) vga_pair: warm-up on seed 100, p50 wall over 101-103.
    cfg = StitchConfig(num_features=1500, blend_type="feather")
    d, _, _ = caps[("vga", VGA_SEEDS[0])]
    stitch(d, cfg, output="", device="cuda")
    lat, errs, zero_band, stage_acc = [], [], [], {}
    for seed in VGA_SEEDS[1:]:
        d, k, rs = caps[("vga", seed)]
        with Recorder(cf, "pyramid_accumulate") as k5_rec:
            res, wall, launches, err, cov, (covered, cut), rec = gated(
                d, k, rs, cfg, VGA["n_images"], VGA["hw"],
                ("find_seams", "fused_compose"))
        nb = [call[0][4] for call in k5_rec.calls["pyramid_accumulate"]]
        assert nb and all(b == 0 for b in nb), f"K5 band counts {nb}"
        zero_band.append(len(nb))
        lat.append(wall)
        errs.append(err)
        for name, secs in res.stage_times.items():
            stage_acc.setdefault(name, []).append(secs)
        if seed == VGA_SEEDS[1]:
            by_path["phase 10b"] = launches
            k5_zero = k5_compose_check(dev, rec.calls["fused_compose"][0],
                                       "vga_pair 0 bands")
        del res
    print(f"phase 10b vga_pair (StitchConfig(num_features=1500, "
          f"blend_type='feather')): kept 2/2 on seeds {VGA_SEEDS[1:]}, "
          f"reprojection {[round(e, 4) for e in errs]} px, walls "
          f"{[round(x, 4) for x in lat]} s, p50 "
          f"{float(np.percentile(lat, 50)) * 1e3:.2f} ms; K5 calls a stitch "
          f"at 0 bands {zero_band}; stage p50 (ms): "
          + ", ".join(f"{name}={np.percentile(v, 50) * 1e3:.2f}"
                      for name, v in stage_acc.items())
          + f"; K5 on the rects of seed {VGA_SEEDS[1]} (feather sharpness "
          f"{k5_zero['feather_sharpness']:.4f}, buckets "
          f"{k5_zero['buckets']}): accumulators {k5_zero['err']:.3g}, u8 "
          f"{k5_zero['u8']}, {k5_zero['launches_per_call']:g} kernel "
          f"launches a call, device {k5_zero['device_ms']:.4f} ms a call, "
          f"bytes bound {k5_zero['bound_ms']:.4f} ms "
          f"({k5_zero['bound_ms'] / k5_zero['device_ms']:.1%} of it "
          f"reached); card '{smi}'", flush=True)

    # (c) the seam finders on DEFAULT_RING, beside phase 9b's dp_color;
    # scipy's graph module is imported first, outside the timed stitches.
    import scipy.sparse.csgraph  # noqa: F401
    seam_s = {"dp_color (phase 9b)": base_9b.stage_times["Finding seams"]}
    for finder in SEAM_FINDERS:
        cfg = StitchConfig(seam_find_type=finder)
        res, wall, launches, err, cov, (covered, cut), _ = gated(
            caps_default, k_true, rs_true, cfg, N_IMAGES, (H, W))
        by_path[f"phase 10c {finder}"] = launches
        seam_s[finder] = res.stage_times["Finding seams"]
        print(f"phase 10c StitchConfig(seam_find_type={finder!r}) on "
              f"DEFAULT_RING: kept {len(res.kept_indices)}/{N_IMAGES}, "
              f"reprojection {err:.4f} px, mask {cov:.4f}, seam union = "
              f"warped union ({covered} px, {cut} px cut), launches "
              f"{launches}, wall {wall:.4f} s, Finding seams "
              f"{seam_s[finder]:.4f} s; card '{smi}'", flush=True)
        del res
    print("phase 10c Finding seams (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in seam_s.items()), flush=True)

    # (d) resume from phase 9b's checkpoint.  With no features wanted,
    # fast ingest decodes at the DCT scale the compose needs (num8 2, the
    # reference's rule), where 9b decoded at num8 8 and resized: other
    # compose pixels, so the panorama is held to 9b's on the legacy
    # decode, which reads the same full-resolution pixels as 9b, and
    # only reported for StitchConfig(serialize_data=False) itself.
    cols = [("phase 9b", base_9b.stage_times)]
    for label, extra, tol in (("", {}, None),
                              (", fast_ingest=False", dict(
                                  fast_ingest=False), 0.5)):
        cfg = StitchConfig(serialize_data=False, checkpoint_dir=ck9b,
                           **extra)
        rec = Recorder(stitcher, "fused_compose", "start_fast_ingest")
        res, wall, launches = stitch_run(stitch, caps_default, cfg,
                                         counters, rec)
        cam_err, mean_diff, n_band, shift = resume_gates(
            res, base_9b, ba_9b, ck9b, rec.calls["fused_compose"][0][0][4],
            corners_9b, tol)
        for name in ("warp_bilinear", "pyramid_accumulate"):
            assert launches[name] > 0, f"{name} was not launched by the path"
        ingest = [kw["want_gray"] for _, kw, _ in
                  rec.calls["start_fast_ingest"]]
        assert ingest == ([False] if cfg.fast_ingest else []), ingest
        if not extra:
            by_path["phase 10d"] = launches
        cols.append((f"10d{label}", res.stage_times))
        print(f"phase 10d resume (StitchConfig(serialize_data=False"
              f"{label})) from phase 9b's checkpoint: kept "
              f"{res.kept_indices} = 9b's, checkpoint cameras within "
              f"{cam_err:.3g} (relative) of 9b's bundle adjustment, "
              f"fast ingest asked for gray {ingest}, panorama "
              f"{tuple(res.panorama.shape)} mean |diff| {mean_diff:.4f} from "
              f"9b's (tol {tol}; canvas origin shifted by {shift}), "
              f"{n_band} mask pixels differ, all on 9b's mask edge; "
              f"launches {launches}; wall {wall:.4f} s against 9b's "
              f"{wall_9b:.4f} s", flush=True)
        del res
    print(stage_table(cols), flush=True)

    # (e) profile_dir and save_graph_to, on the vga_pair set of seed 101.
    prof, dot = os.path.join(work, "profile"), os.path.join(work, "g.dot")
    d, _, _ = caps[("vga", VGA_SEEDS[1])]
    cfg = StitchConfig(num_features=1500, blend_type="feather",
                       profile_dir=prof, save_graph=True, save_graph_to=dot)
    res, wall, launches = stitch_run(stitch, d, cfg, counters)
    trace = os.path.join(prof, "stitch_trace.json")
    assert os.path.getsize(trace) > 0 and os.path.getsize(dot) > 0
    text = open(dot).read()
    edges = [f'"{a}.jpg" -- "{a + 1}.jpg"' for a in res.kept_indices[:-1]]
    missing = [e for e in edges if e not in text]
    assert not missing, f"DOT file lacks {missing}"
    by_path["phase 10e"] = launches
    print(f"phase 10e profile_dir + save_graph_to (vga_pair seed "
          f"{VGA_SEEDS[1]}): trace {os.path.getsize(trace)} bytes, DOT "
          f"{os.path.getsize(dot)} bytes with {text.count(' -- ')} edges, "
          f"every kept adjacent pair among them; wall {wall:.4f} s "
          f"(profiled); launches {launches}", flush=True)
    os.remove(trace)
    return dict(by_path=by_path, k5_zero_band=k5_zero)


# Phase 11's capture sets.  rig37 as bench.py makes it (bench.py:322-375):
# the C++ reference's 37-image rig at 960x1280, seed 21, its warm-up twin
# with +-2 LSB noise, and a copy with frames 5, 15 and 30 made noise.
RIG_HW = (960, 1280)
RIG_SEED = 21
INFILL_FRAMES = (5, 15, 30)
# The affine scan: a 2x2 mosaic of 1080x1920 tiles, 40% overlap, cut from
# one planar texture, each tile under a similarity (rotation <= 3 deg,
# scale 0.97-1.03), sigma-8 sensor noise.
TILE_HW = (1080, 1920)
TILE_STEP = (648, 1152)
# The rig covers the whole sphere (the +-72 deg rings reach 98.8 deg with
# their 26.8 deg vertical half field of view), so its panorama is held to
# the 0.9 coverage of phase 4, not the 0.5 of the JAX package's two-ring
# test (tests/test_rig_e2e.py), whose canvas holds uncovered poles; the
# coverage is taken over one 2 pi period of the canvas (folded), since
# the views across the date line reach past it.
RIG_MASK_MIN = 0.9
TEXTURE_RAD_PER_PX = 1.0 / 1600.0
AFFINE_CFG = dict(matcher_type="affine", estimator_type="affine",
                  ba_cost_func="affine", warp_type="affine",
                  do_wave_correct=False)


def noisy_twin(images, seed: int = 777):
    """bench.py's warm-up twin (`_noisy_twin_dir`): the same scene with
    +-2 LSB uniform noise, so every shape matches the timed run."""
    rng = np.random.default_rng(seed)
    return [np.clip(im.astype(np.int16) + rng.integers(
        -2, 3, im.shape, dtype=np.int16), 0, 255).astype(np.uint8)
        for im in images]


def affine_tiles(pool):
    """The affine scan's tiles: tile i's pixel p lies at T_i p =
    s_i R(theta_i) (p - centre) + its grid centre on a plane whose
    coordinates, scaled to radians, are the sphere texture's (lon, lat).
    Returns (images, [3x3 similarity from tile i's pixels to tile 0's])."""
    from image_stitching_tpu_torch.data.synth import sphere_texture_rgb
    rng = np.random.default_rng(31)
    h, w = TILE_HW
    pc = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    mid = pc + np.array([TILE_STEP[1], TILE_STEP[0]]) / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ts, jobs = [], []
    for row in range(2):
        for col in range(2):
            th = np.radians(rng.uniform(-3.0, 3.0))
            sc = rng.uniform(0.97, 1.03)
            lin = sc * np.array([[np.cos(th), -np.sin(th)],
                                 [np.sin(th), np.cos(th)]])
            t = np.eye(3)
            t[:2, :2] = lin
            t[:2, 2] = pc + np.array([col * TILE_STEP[1],
                                      row * TILE_STEP[0]]) - lin @ pc
            gx = t[0, 0] * xs + t[0, 1] * ys + t[0, 2]
            gy = t[1, 0] * xs + t[1, 1] * ys + t[1, 2]
            jobs.append((((gx - mid[0]) * TEXTURE_RAD_PER_PX).astype(
                np.float32), ((gy - mid[1]) * TEXTURE_RAD_PER_PX).astype(
                    np.float32)))
            ts.append(t)
    views = pool.starmap(sphere_texture_rgb, jobs)
    images = [np.clip(v + np.random.default_rng(2000 + i).normal(
        0.0, 8.0, v.shape).astype(np.float32), 0.0, 255.0)
        for i, v in enumerate(views)]
    return images, [np.linalg.inv(ts[0]) @ t for t in ts]


def render_phase11_dirs(root: str, workers: int):
    """Phase 11's capture sets, the views rendered in one process pool:
    {name: directory} for "rig37", "rig37 warm-up", "rig37 infill" (all
    with EXIF priors) and "affine" (without), and the ground truth."""
    import multiprocessing as mp
    from image_stitching_tpu_torch.data.synth import (make_rig_captures,
                                                      write_capture_dir)
    with mp.get_context("spawn").Pool(workers) as pool:
        images, k, rs = make_rig_captures(hw=RIG_HW, seed=RIG_SEED,
                                          pool=pool)
        tiles, truths = affine_tiles(pool)
    dirs = {name: os.path.join(root, name.replace(" ", "_"))
            for name in ("rig37", "rig37 warm-up", "rig37 infill", "affine")}
    write_capture_dir(dirs["rig37"], images, k, rs)
    write_capture_dir(dirs["rig37 warm-up"], noisy_twin(images), k, rs)
    rng = np.random.default_rng(5)
    dropped = [rng.uniform(0, 255, images[0].shape).astype(np.float32)
               if i in INFILL_FRAMES else im for i, im in enumerate(images)]
    write_capture_dir(dirs["rig37 infill"], dropped, k, rs)
    write_capture_dir(dirs["affine"], tiles, np.eye(3, dtype=np.float32),
                      np.stack([np.eye(3, dtype=np.float32)] * 4),
                      with_exif=False)
    return dirs, dict(k=np.asarray(k, np.float64),
                      rs=np.asarray(rs, np.float64), tiles=truths)


def overlapping_pairs(kept, rs_true, max_angle_deg: float):
    """Positions (a, b) in `kept` whose ground-truth optical axes are
    within max_angle_deg (bench.py `_overlapping_pairs`)."""
    z = np.stack([np.asarray(rs_true[i], np.float64)[:, 2] for i in kept])
    ang = np.degrees(np.arccos(np.clip(z @ z.T, -1.0, 1.0)))
    return [(a, b) for a in range(len(kept)) for b in range(a + 1, len(kept))
            if ang[a, b] <= max_angle_deg]


def rel_rotation_deg(ra, rb) -> float:
    """Angle (degrees) of ra rb^T."""
    m = np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T
    # atan2 of the skew and symmetric parts: arccos((tr - 1) / 2) loses
    # ~0.04 degree near 0 to float32 rotations' 1e-7 scale error.
    sin = np.linalg.norm([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                          m[1, 0] - m[0, 1]]) / 2
    return float(np.degrees(np.arctan2(sin, (np.trace(m) - 1) / 2)))


def gains_gate(compose_call):
    """Every image's exposure gains finite and positive."""
    comp = compose_call[0][9]
    for i, (gh, gw) in enumerate(comp.grid_sizes):
        gains = comp.gains[i, :gh, :gw]
        assert np.all(np.isfinite(gains)) and np.all(gains > 0), \
            f"image {i}: gains not finite and positive"


def folded_coverage(mask, compose_call) -> float:
    """The share of one u period of the spherical canvas (2 pi times the
    compose warper's scale) that the panorama's mask covers, its columns
    folded modulo the period."""
    from image_stitching_tpu_torch.ops.warps import u_period
    warper = compose_call[0][3]
    period = u_period(warper.proj_name, warper.scale)
    h, w = mask.shape
    cols = torch.arange(w, device=mask.device) % period
    folded = torch.zeros((h, period), device=mask.device).index_add_(
        1, cols, mask.float())
    return float((folded > 0).float().mean())


def affine_union_gate(res, cfg, compose_call):
    """The panorama's mask against the union of the warped tiles on the
    compose canvas (each tile's map by the compose's own geometry and
    `camera_backward_xy`): the share of the union the mask covers."""
    from image_stitching_tpu_torch.ops.warps import camera_backward_xy
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    args = compose_call[0]
    images, ks, rs, warper, corners, sizes = args[:6]
    g = cf.compose_rects(corners, sizes, cfg.blend_type, cfg.blend_strength)
    cx, cy, cw, ch = g.canvas
    dev = res.mask.device
    us = cx + torch.arange(cw, dtype=torch.float32, device=dev)
    vs = cy + torch.arange(ch, dtype=torch.float32, device=dev)
    hc, wc = images.shape[1], images.shape[2]
    union = torch.zeros((ch, cw), dtype=torch.bool, device=dev)
    for i in range(len(ks)):
        sx, sy, valid = camera_backward_xy(
            warper.proj_name, us, vs, torch.as_tensor(ks[i], device=dev),
            torch.as_tensor(rs[i], device=dev), warper.scale)
        union |= valid & (sx >= 0) & (sx <= wc - 1) & (sy >= 0) & \
            (sy <= hc - 1)
    assert tuple(res.mask.shape) == (ch, cw), (tuple(res.mask.shape), ch, cw)
    share = float((res.mask & union).sum()) / float(union.sum())
    return share, float(union.float().mean())


def run_phase11(stitch, stitcher, counters, names, caps11, truth,
                caps_default, caps_plain, k_true, rs_true, smi, dev):
    """Phase 11, camera seeding and the registration variants, each stitch
    under the counts as in phase 9: (a) DEFAULT_RING without EXIF under
    StitchConfig(), and StitchConfig(use_sensor_priors=False) on the EXIF
    files; (b) rig37, warm-up then timed, with K4 and K5 against their
    plain versions on its shapes; (c) pose infill on rig37 with three
    frames of noise; (d) the affine scan mode on a 2x2 mosaic, K2 on its
    rects; (e) ba_cost_func="ray" on DEFAULT_RING.  Returns the counts by
    path and the kernel numbers of (b) and (d)."""
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.core.rig import DEFAULT_RIG
    from image_stitching_tpu_torch.estimation.homography_estimator import (
        pair_focals)
    from image_stitching_tpu_torch.estimation.pose_infill import (
        find_nearest_kept)
    from image_stitching_tpu_torch.kernels.ransac_score import (
        ransac_score_counts)
    from image_stitching_tpu_torch.kernels.warp_gather import warp_bilinear
    from image_stitching_tpu_torch.ops import ransac as ransac_mod
    by_path = {}

    # (a) No EXIF priors: the seed from the match graph, then reproj BA.
    # The seed's autocalib focal (estimate_focal, the median of per-pair
    # estimates, as in OpenCV) is erratic on a pure-yaw ring, and the
    # default refine mask leaves the focal alone: the reprojection error
    # is reported beside the per-pair estimates, not gated.
    cfg = StitchConfig()
    rec = Recorder(stitcher, "find_seams", "fused_compose",
                   "homography_based_estimate")
    res, wall, launches = stitch_run(stitch, caps_plain, cfg, counters, rec)
    assert res.kept_indices == list(range(N_IMAGES)), res.kept_indices
    assert bool(torch.isfinite(res.panorama).all()), "non-finite panorama"
    err = reproj_err_px(res.cameras, res.kept_indices, k_true, rs_true,
                        res.work_scale)
    cov = float(res.mask.float().mean())
    assert cov > 0.9, f"mask coverage {cov:.4f}"
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    covered, cut = seam_union_gate(rec.calls["find_seams"][0])
    gains_gate(rec.calls["fused_compose"][0])
    by_path["phase 11a"] = launches
    focal = float(res.cameras.numpy()["focal"].mean())
    pm, sizes, thresh = rec.calls["homography_based_estimate"][0][0]
    pair_f = pair_focals(pm.h, pm.confidence, sizes, thresh)
    near = sum(abs(f / k_true[0, 0] - 1) <= 0.01 for f in pair_f)
    print(f"phase 11a StitchConfig() on DEFAULT_RING written without EXIF "
          f"(seed: homography_based_estimate): kept "
          f"{len(res.kept_indices)}/{N_IMAGES}, focal {focal:.2f} against "
          f"the ground truth's {k_true[0, 0]:.2f} "
          f"({focal / k_true[0, 0] - 1:+.4%}; per ordered pair "
          f"sqrt(f0 f1): {[round(f, 1) for f in pair_f]}, {near} of "
          f"{len(pair_f)} within 1%), reprojection {err:.4f} px (reported, "
          f"not gated), panorama {tuple(res.panorama.shape)}, mask "
          f"{cov:.4f}, seam union = warped union ({covered} px, {cut} px "
          f"cut), launches {launches}, wall {wall:.4f} s, stages: "
          + ", ".join(f"{k}={v:.4f}s" for k, v in res.stage_times.items())
          + f"; card '{smi}'", flush=True)
    cfg = StitchConfig(use_sensor_priors=False)
    res_p, wall_p, launches_p = stitch_run(stitch, caps_default, cfg,
                                           counters)
    assert res_p.kept_indices == res.kept_indices, \
        (res_p.kept_indices, res.kept_indices)
    cam_err = 0.0
    a, b = res_p.cameras.numpy(), res.cameras.numpy()
    for name in ("focal", "aspect", "ppx", "ppy", "R", "t"):
        x, y = a[name].astype(np.float64), b[name].astype(np.float64)
        cam_err = max(cam_err, float(np.abs(x - y).max() /
                                     max(np.abs(y).max(), 1e-12)))
    assert cam_err <= 1e-4, f"cameras differ by {cam_err} (relative)"
    for name in names:
        assert launches_p[name] > 0, f"{name} was not launched by the path"
    by_path["phase 11a use_sensor_priors=False"] = launches_p
    print(f"phase 11a StitchConfig(use_sensor_priors=False) on the EXIF "
          f"files: kept {res_p.kept_indices} = 11a's, cameras within "
          f"{cam_err:.3g} (relative, tol 1e-4) of 11a's, launches "
          f"{launches_p}, wall {wall_p:.4f} s", flush=True)
    del res, res_p, rec

    # (b) rig37: warm-up on the noisy twin, then the timed stitch.
    cfg = StitchConfig(num_features=1000)
    stitch(caps11["rig37 warm-up"], cfg, output="", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = Recorder(stitcher, "match_all_pairs", "find_seams",
                   "fused_compose")
    ransac_score_counts.launches = 0
    with Recorder(ransac_mod, "ransac_score_counts") as rec7:
        res, wall, launches = stitch_run(stitch, caps11["rig37"], cfg,
                                         counters, rec)
    peak = torch.cuda.max_memory_allocated()
    k7_launches = ransac_score_counts.launches
    n_rig = DEFAULT_RIG.total_images
    assert res.kept_indices == list(range(n_rig)), res.kept_indices
    pairs = overlapping_pairs(res.kept_indices, truth["rs"], 45.0)
    err = reproj_err_px(res.cameras, res.kept_indices, truth["k"],
                        truth["rs"], res.work_scale, RIG_HW, pairs)
    assert err <= 1.0, f"rig37 reprojection {err:.4f} px > 1 px"
    cov = float(res.mask.float().mean())
    sphere = folded_coverage(res.mask, rec.calls["fused_compose"][0])
    assert sphere > RIG_MASK_MIN, f"rig37 mask covers {sphere:.4f}"
    covered, cut = seam_union_gate(rec.calls["find_seams"][0])
    gains_gate(rec.calls["fused_compose"][0])
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    by_path["phase 11b"] = launches
    mp_in = n_rig * RIG_HW[0] * RIG_HW[1] / 1e6
    print(f"phase 11b rig37 (StitchConfig(num_features=1000), 37 x "
          f"{RIG_HW[0]}x{RIG_HW[1]}, seed {RIG_SEED}, after a warm-up on its "
          f"+-2 LSB twin): kept {len(res.kept_indices)}/{n_rig}, reprojection "
          f"{err:.4f} px over {len(pairs)} pairs within 45 deg, panorama "
          f"{tuple(res.panorama.shape)}, mask {sphere:.4f} of one 2 pi "
          f"period of the canvas (gate {RIG_MASK_MIN}; {cov:.4f} of the "
          f"whole canvas), seam union = warped union ({covered} px, {cut} "
          f"px cut), launches {launches}, wall {wall:.4f} s "
          f"({mp_in / wall:.3f} MP/s, {mp_in:.2f} MP in), peak device memory "
          f"{peak / 2 ** 30:.3f} GiB ({peak} bytes); card '{smi}'\n"
          + stage_table([("rig37", res.stage_times)]), flush=True)
    feats = rec.calls["match_all_pairs"][0][0][0]
    args = k4_args(dev, feats)
    k4 = dict(k4_times(args, feats.valid), pairs=len(args[2]))
    print(f"phase 11b K4 on rig37's descriptors: {len(args[2])} pairs of "
          f"K={feats.xy.shape[1]}, both directions, one call: equal to the "
          f"plain version; device {k4['dev_ms']:.4f} ms, call "
          f"{k4['call_ms']:.4f} ms, plain {k4['plain_ms']:.4f} ms; bound "
          f"over {k4['n_dist']:.0f} valid distances {k4['bound_ms']:.4f} ms "
          f"({k4['route']}; CUDA cores {k4['cuda_core_ms']:.4f} ms), "
          f"{k4['bound_ms'] / k4['dev_ms']:.1%} of it reached", flush=True)
    k5 = k5_compose_check(dev, rec.calls["fused_compose"][0], "rig37")
    print(f"phase 11b K5 on rig37's compose: {len(k5['buckets'])} buckets "
          f"{k5['buckets']}, one call each, {k5['n_bands']} bands: "
          f"accumulators {k5['err']:.3g}, u8 {k5['u8']}, masks equal, "
          f"{k5['launches_per_call']:g} kernel launches a call, device "
          f"{k5['device_ms']:.4f} ms a call, bytes bound "
          f"{k5['bound_ms']:.4f} ms a call "
          f"({k5['bound_ms'] / k5['device_ms']:.1%} of it reached)",
          flush=True)
    k7 = check_k7(rec7.calls["ransac_score_counts"], "11b", k7_launches)
    del res, rec, rec7, feats, args

    # (c) Pose infill: frames 5, 15, 30 are noise, so the component drops
    # them, and infill_dropped makes their cameras from their ring's
    # nearest kept neighbour (n = 37, the rig's ring-aware search).
    cfg = StitchConfig(num_features=1000, infill_dropped=True)
    rec = Recorder(stitcher, "biggest_component")
    res, wall, launches = stitch_run(stitch, caps11["rig37 infill"], cfg,
                                     counters, rec)
    kept, removed = rec.calls["biggest_component"][0][2]
    assert set(INFILL_FRAMES) <= set(removed), removed
    assert len(res.cameras) == n_rig, len(res.cameras)
    assert res.kept_indices == list(range(n_rig)), res.kept_indices
    r_est = res.cameras.numpy()["R"]
    errs = {}
    for j in removed:
        nb = find_nearest_kept(set(kept), j, n_rig, DEFAULT_RIG)
        errs[j] = (nb, rel_rotation_deg(r_est[nb].T @ r_est[j],
                                        truth["rs"][nb].T @ truth["rs"][j]))
        if j in INFILL_FRAMES:
            assert errs[j][1] <= 1.0, (j, errs[j])
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    by_path["phase 11c"] = launches
    print(f"phase 11c infill (StitchConfig(num_features=1000, "
          f"infill_dropped=True)) on rig37 with frames {INFILL_FRAMES} made "
          f"noise: the component removed {removed}, {len(kept)} kept into "
          f"BA; returned {len(res.cameras)} cameras, kept_indices "
          f"range(37); each infilled camera against its neighbour, relative "
          f"rotation error vs the ground truth (deg, tol 1 for the noise "
          f"frames): " + ", ".join(f"{j} from {nb}: {e:.4f}"
                                   for j, (nb, e) in errs.items())
          + f"; panorama {tuple(res.panorama.shape)}, launches {launches}, "
          f"wall {wall:.4f} s", flush=True)
    del res, rec

    # (d) The affine scan mode on the 2x2 mosaic (no EXIF).
    cfg = StitchConfig(**AFFINE_CFG)
    rec = Recorder(stitcher, "find_seams", "fused_compose")
    res, wall, launches = stitch_run(stitch, caps11["affine"], cfg, counters,
                                     rec)
    assert res.kept_indices == [0, 1, 2, 3], res.kept_indices
    r_est = res.cameras.numpy()["R"].astype(np.float64)
    tile_err = []
    for got, want in zip(r_est, truth["tiles"]):
        ang = np.degrees(np.arctan2(got[1, 0], got[0, 0]) -
                         np.arctan2(want[1, 0], want[0, 0]))
        scale = np.hypot(got[0, 0], got[1, 0]) / np.hypot(want[0, 0],
                                                          want[1, 0]) - 1
        shift = float(np.hypot(*(got[:2, 2] - want[:2, 2])))
        assert abs(ang) <= 0.5 and abs(scale) <= 0.01, (ang, scale)
        tile_err.append(tuple(round(float(v), 5)
                              for v in (ang, scale, shift)))
    share, union_cov = affine_union_gate(res, cfg,
                                         rec.calls["fused_compose"][0])
    assert share > 0.9, f"mask covers {share:.4f} of the warped tiles"
    covered, cut = seam_union_gate(rec.calls["find_seams"][0])
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    by_path["phase 11d"] = launches
    calls, g = compose_k2_calls(rec.calls["fused_compose"][0])
    k2_err = k2_max_diff(calls)
    k2_ms = device_ms(lambda: [warp_bilinear(*c) for c in calls]) / \
        len(calls)
    k2_bound_ms, k2_by = k2_bound(calls)
    print(f"phase 11d affine scan (matcher, estimator, BA and warp affine, "
          f"no wave correction) on a 2x2 mosaic of {TILE_HW[0]}x"
          f"{TILE_HW[1]} tiles without EXIF: kept {res.kept_indices}; each "
          f"tile's similarity against the truth relative to tile 0 (rotation "
          f"deg, scale - 1, translation px at work scale "
          f"{res.work_scale}): {tile_err} "
          f"(tol 0.5 deg, 1%); panorama {tuple(res.panorama.shape)}, mask "
          f"{float(res.mask.float().mean()):.4f} of the canvas, "
          f"{share:.4f} of the warped tiles' union ({union_cov:.4f} of the "
          f"canvas), seam union = warped union ({covered} px, {cut} px cut), "
          f"launches {launches}, wall {wall:.4f} s; K2 on its {len(calls)} "
          f"compose rects {sorted((3,) + k for k in g.buckets)}: max |diff| "
          f"{k2_err:.3g}, device {k2_ms:.4f} ms a rect, bound "
          f"{k2_bound_ms:.4f} ms ({k2_by}, {k2_bound_ms / k2_ms:.1%} of it "
          f"reached); card '{smi}'", flush=True)
    del res, rec, calls

    # (e) The ray cost on DEFAULT_RING with priors, under phase 9b's gates.
    cfg = StitchConfig(ba_cost_func="ray")
    rec = Recorder(stitcher, "find_seams", "fused_compose")
    res, wall, launches = stitch_run(stitch, caps_default, cfg, counters,
                                     rec)
    err, cov, stages = e2e_gates(res, k_true, rs_true, launches, names)
    covered, cut = seam_union_gate(rec.calls["find_seams"][0])
    gains_gate(rec.calls["fused_compose"][0])
    by_path["phase 11e"] = launches
    print(f"phase 11e StitchConfig(ba_cost_func='ray') on DEFAULT_RING: kept "
          f"{len(res.kept_indices)}/{N_IMAGES}, reprojection {err:.4f} px, "
          f"mask {cov:.4f}, seam union = warped union ({covered} px, {cut} "
          f"px cut), launches {launches}, wall {wall:.4f} s, stages: "
          f"{stages}; card '{smi}'", flush=True)
    del res, rec
    return dict(by_path=by_path, k4=k4, k5=k5, k7=k7, peak_bytes=peak,
                k2=dict(device_ms=k2_ms, bound_ms=k2_bound_ms, err=k2_err))


# Phase 12's capture sets.  mixed8: DEFAULT_RING's geometry with the odd
# views at 12 MP, each view at its own K (the same 55 deg field of view)
# and its own EXIF payload; spher16 as bench.py makes it
# (bench.py:445-519) with DEFAULT_RING's sigma-8 noise, and its +-2 LSB
# warm-up twin.
MIXED_HWS = [(2448, 3264), (3000, 4000)] * 4
SPHER16 = dict(n_images=16, hw=(3000, 4000), fov_deg=55.0,
               overlap_ratio=0.45, seed=41)


def write_mixed_dir(directory, hws, pool, fov_deg=55.0, overlap_ratio=0.5,
                    seed=7, noise_sigma=8.0):
    """A horizontal ring whose view i is rendered at its own size hws[i]
    with its own K (one horizontal field of view) and the sensor noise of
    `write_ring_dir` (seed 1000 + i), written as JPEGs stored rotated 180
    degrees with each view's own EXIF pose payload.  Returns the ground
    truth ([K float64], [R float64])."""
    from image_stitching_tpu_torch.core import exif, image_io
    from image_stitching_tpu_torch.data.synth import (_render_noisy,
                                                      ring_geometry)
    geo = [ring_geometry(len(hws), hw, fov_deg, overlap_ratio)
           for hw in hws]
    images = pool.map(_render_noisy, [
        (i, geo[i][0], geo[i][1][i], hw, seed, noise_sigma)
        for i, hw in enumerate(hws)])
    os.makedirs(directory, exist_ok=True)
    ks, rs = [], []
    for i, img in enumerate(images):
        k = geo[i][0].astype(np.float32)
        r = geo[i][1][i].astype(np.float32)
        payload = exif.camera_to_image_description(
            focal=float(k[1, 1]), ppx=float(k[0, 2]), ppy=float(k[1, 2]),
            R=r, is_portrait=False)
        image_io.write_jpeg_with_description(
            os.path.join(directory, f"{i}.jpg"),
            image_io.rotate_180(np.clip(img, 0, 255).astype(np.uint8)),
            payload, quality=92)
        ks.append(k.astype(np.float64))
        rs.append(r.astype(np.float64))
    return ks, rs


def render_phase12_dirs(root: str, workers: int):
    """Phase 12's capture sets, the views rendered in one process pool:
    {name: directory} for "mixed8", "spher16" and "spher16 warm-up", and
    their ground truth."""
    import multiprocessing as mp
    from image_stitching_tpu_torch.data.synth import (_noisy_views,
                                                      ring_geometry,
                                                      write_capture_dir)
    dirs = {name: os.path.join(root, name.replace(" ", "_"))
            for name in ("mixed8", "spher16", "spher16 warm-up")}
    with mp.get_context("spawn").Pool(workers) as pool:
        ks, rs = write_mixed_dir(dirs["mixed8"], MIXED_HWS, pool)
        g = SPHER16
        k16, rs16 = ring_geometry(g["n_images"], g["hw"], g["fov_deg"],
                                  g["overlap_ratio"])
        images, k32, rs32 = _noisy_views(k16, rs16, g["hw"], g["seed"],
                                         DEFAULT_RING["noise_sigma"], pool)
    write_capture_dir(dirs["spher16"], images, k32, rs32)
    write_capture_dir(dirs["spher16 warm-up"], noisy_twin(images), k32,
                      rs32)
    return dirs, dict(mixed_k=ks, mixed_rs=rs,
                      k16=np.asarray(k32, np.float64),
                      rs16=[np.asarray(r, np.float64) for r in rs32])


class HostTimer:
    """Pass-through wrapper on a module function that adds each call's
    host seconds to `seconds` while the context is open."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.seconds = 0.0

    def __enter__(self):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self.orig(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def k2_loop_check(calls):
    """K2 on the loop compose's (src, sx, sy) calls: against its plain
    version under phase 3's gate, device and call ms per call, the plain
    version's ms and the bound."""
    from image_stitching_tpu_torch.kernels.warp_gather import (
        warp_bilinear, warp_bilinear_plain)
    err = k2_max_diff(calls)

    def run(fn):
        for src, sx, sy in calls:
            fn(src, sx, sy)
    bound_ms, bound_by = k2_bound(calls)
    return dict(err=err,
                device_ms=device_ms(lambda: run(warp_bilinear)) / len(calls),
                call_ms=time_ms(lambda: run(warp_bilinear)) / len(calls),
                plain_ms=time_ms(lambda: run(warp_bilinear_plain), reps=3)
                / len(calls), library_ms=k2_library_ms(calls)[0],
                bound_ms=bound_ms, bound_by=bound_by)


def k5_loop_check(calls):
    """K5 on the loop blender's calls (a bucket of one padded rect each,
    into the blender's band accumulators), replayed into fresh
    accumulators against its plain version under phase 7's gates; kernel
    launches, device and call ms per call, the plain version's ms, and the
    bound per call (the rect in, its window in every band read and written
    once)."""
    from image_stitching_tpu_torch.kernels.multiband import (
        band_offsets, pyramid_accumulate, pyramid_accumulate_plain)
    nb = calls[0][4]
    shapes = [tuple(a.shape) for a in calls[0][3]]
    dev = calls[0][0].device

    def fresh():
        return [torch.zeros(sh, device=dev) for sh in shapes]
    acc_k, acc_p, scratch = fresh(), fresh(), fresh()
    for warped, weight, offs, _, _ in calls:
        pyramid_accumulate(warped, weight, offs, acc_k, nb)
        pyramid_accumulate_plain(warped, weight, offs, acc_p, nb)
    err, u8 = _k5_gates(acc_k, acc_p, nb, "loop compose")

    def run(fn):
        for warped, weight, offs, _, _ in calls:
            fn(warped, weight, offs, scratch, nb)
    per_call = kernel_launches(lambda: run(pyramid_accumulate)) / len(calls)
    assert per_call <= 2 * nb + 1, f"K5 loop: {per_call} launches a call"
    n_bytes = n_ops = 0.0
    for warped, weight, offs, _, _ in calls:
        _, ph, pw = weight.shape
        n_bytes += 16 * ph * pw + sum(
            2 * 16 * (ph >> b) * (pw >> b) for b in range(nb + 1))
        n_ops += (sum(4 * 50 * (ph >> b) * (pw >> b)
                      for b in range(1, nb + 1)) +
                  sum((3 * 18 + 12) * (ph >> b) * (pw >> b)
                      for b in range(nb + 1)))
        assert len(band_offsets(offs[0], scratch, ph, pw)) == nb + 1
    bound_ms, bound_by = bound(n_bytes / len(calls), n_ops / len(calls))
    return dict(err=err, u8=u8, n_bands=nb, launches_per_call=per_call,
                rects=sorted({tuple(c[0].shape) for c in calls}),
                device_ms=device_ms(lambda: run(pyramid_accumulate)) /
                len(calls),
                call_ms=time_ms(lambda: run(pyramid_accumulate)) /
                len(calls),
                plain_ms=time_ms(lambda: run(pyramid_accumulate_plain),
                                 reps=3) / len(calls),
                bound_ms=bound_ms, bound_by=bound_by)


def run_phase12(stitch, counters, names, caps12, truth, caps_default,
                k_true, rs_true, base_9b, work, smi):
    """Phase 12, the loop compose, each stitch under the counts as in
    phase 9: (a) mixed8, StitchConfig() on DEFAULT_RING's geometry at two
    sizes (legacy decode, ORB per image, the host exposure feed, the loop
    compose), after a warm-up on the same files, with K2 and K5 on the
    loop's shapes; (b) StitchConfig(timelapse=True, timelapse_type=
    "as_is") on DEFAULT_RING in a working directory of its own; (c)
    spher16, StitchConfig(crop_result=True) on 16 x 3000x4000 after a
    warm-up on its +-2 LSB twin.  Returns the counts by path and the
    kernel numbers of (a)."""
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.ops import blend, crop, warps
    from image_stitching_tpu_torch.ops.warps import result_roi
    from image_stitching_tpu_torch.pipeline import stitcher
    by_path = {}

    # (a) mixed8 under StitchConfig().
    cfg = StitchConfig()
    n_mixed = len(MIXED_HWS)
    stitch(caps12["mixed8"], cfg, output="", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = [Recorder(warps, "warp_bilinear"),
           Recorder(blend, "pyramid_accumulate"),
           Recorder(stitcher, "start_fast_ingest", "feed", "find_seams")]
    with rec[0], rec[1]:
        res, wall, launches = stitch_run(stitch, caps12["mixed8"], cfg,
                                         counters, rec[2])
    peak = torch.cuda.max_memory_allocated()
    assert rec[2].calls["start_fast_ingest"][0][2] is None, \
        "fast ingest took a mixed-size set"
    assert res.kept_indices == list(range(n_mixed)), res.kept_indices
    assert bool(torch.isfinite(res.panorama).all()), "non-finite panorama"
    err = reproj_err_px(res.cameras, res.kept_indices, truth["mixed_k"],
                        truth["mixed_rs"], res.work_scale, list(MIXED_HWS))
    assert err <= 1.0, f"mixed8 reprojection {err:.4f} px > 1 px"
    cov = float(res.mask.float().mean())
    assert cov > 0.9, f"mixed8 mask coverage {cov:.4f}"
    comp = rec[2].calls["feed"][0][2]
    for i, (gh, gw) in enumerate(comp.grid_sizes):
        gains = comp.gains[i, :gh, :gw]
        assert np.all(np.isfinite(gains)) and np.all(gains > 0), \
            f"mixed8 image {i}: gains not finite and positive"
    covered, cut = seam_union_gate(rec[2].calls["find_seams"][0])
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    k2_calls = [args for args, _, _ in rec[0].calls["warp_bilinear"]]
    k5_calls = [args for args, _, _ in rec[1].calls["pyramid_accumulate"]]
    assert len(k2_calls) == 2 * n_mixed and len(k5_calls) == n_mixed, \
        (len(k2_calls), len(k5_calls))
    by_path["phase 12a"] = launches
    mp_in = sum(h * w for h, w in MIXED_HWS) / 1e6
    mixed_stages = res.stage_times
    print(f"phase 12a mixed8 (StitchConfig(), {n_mixed} views of "
          f"{sorted(set(MIXED_HWS))} alternating, DEFAULT_RING's geometry, "
          f"each view its own K; after a warm-up on the same files): fast "
          f"ingest declined the set "
          f"(legacy decode), kept {len(res.kept_indices)}/{n_mixed}, "
          f"reprojection {err:.4f} px (per-image K), panorama "
          f"{tuple(res.panorama.shape)} float, mask {cov:.4f}, gains "
          f"finite and positive (host feed, grids "
          f"{[tuple(int(v) for v in g) for g in comp.grid_sizes]}), seam "
          f"union = warped union ({covered} px, {cut} px cut), launches "
          f"{launches}, wall {wall:.4f} s ({mp_in / wall:.3f} MP/s, "
          f"{mp_in:.2f} MP in), peak device memory {peak / 2 ** 30:.3f} GiB "
          f"({peak} bytes); card '{smi}'", flush=True)
    del res, rec
    k2 = k2_loop_check(k2_calls[n_mixed:])
    print(f"phase 12a K2 on the loop compose's {n_mixed} rects "
          f"{sorted({tuple(c[1].shape) for c in k2_calls[n_mixed:]})} "
          f"(sources {sorted({tuple(c[0].shape) for c in k2_calls[n_mixed:]})}"
          f"; {n_mixed} more seam-scale warps in the stitch): max |diff| "
          f"{k2['err']:.3g} (atol 1e-4), per call: kernel device "
          f"{k2['device_ms']:.4f} ms, call {k2['call_ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, grid_sample device "
          f"{k2['library_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2['bound_by']}, {k2['bound_ms'] / k2['device_ms']:.1%} of it "
          f"reached)", flush=True)
    k5 = k5_loop_check(k5_calls)
    print(f"phase 12a K5 on the loop blender's {n_mixed} calls (a bucket of "
          f"one each, rects {k5['rects']}, {k5['n_bands']} bands): "
          f"accumulators {k5['err']:.3g} (tol 2e-3), finalized u8 "
          f"{k5['u8']} (tol 1), masks equal, {k5['launches_per_call']:g} "
          f"kernel launches a call; per call: kernel device "
          f"{k5['device_ms']:.4f} ms, call {k5['call_ms']:.4f} ms, plain "
          f"{k5['plain_ms']:.4f} ms, bound {k5['bound_ms']:.4f} ms "
          f"({k5['bound_by']}, {k5['bound_ms'] / k5['device_ms']:.1%} of it "
          f"reached)", flush=True)
    del k2_calls, k5_calls

    # (b) The timelapse on DEFAULT_RING, in a working directory of its own
    # (the frames go to it), with the default result name.
    cfg = StitchConfig(timelapse=True, timelapse_type="as_is")
    tl_dir = os.path.join(work, "timelapse")
    os.makedirs(tl_dir)
    cwd = os.getcwd()
    os.chdir(tl_dir)
    try:
        rec = Recorder(stitcher, "_loop_compose")
        res, wall, launches = stitch_run(stitch, caps_default, cfg,
                                         counters, rec, output=None)
    finally:
        os.chdir(cwd)
    comp_in = rec.calls["_loop_compose"][0][0][1]
    _, _, cw, ch = result_roi(comp_in.corners, comp_in.sizes)
    frames = sorted(f for f in os.listdir(tl_dir) if f.startswith("fixed_"))
    assert frames == sorted(f"fixed_{i}.jpg" for i in range(N_IMAGES)), \
        frames
    assert res.timelapse_frames == [f"fixed_{i}.jpg"
                                    for i in range(N_IMAGES)]
    assert not os.path.exists(os.path.join(tl_dir, "result.jpg")), \
        "the timelapse wrote result.jpg"
    from PIL import Image
    for f in frames:
        with Image.open(os.path.join(tl_dir, f)) as im:
            assert im.size == (cw, ch), (f, im.size, (cw, ch))
    assert res.kept_indices == list(range(N_IMAGES)), res.kept_indices
    err = reproj_err_px(res.cameras, res.kept_indices, k_true, rs_true,
                        res.work_scale)
    assert err <= 1.0, f"timelapse reprojection {err:.4f} px > 1 px"
    tl_names = [nm for nm in names if nm != "pyramid_accumulate"]
    for name in tl_names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    assert launches["warp_bilinear"] >= N_IMAGES, launches
    by_path["phase 12b"] = launches
    timelapse_stages = res.stage_times
    print(f"phase 12b timelapse (StitchConfig(timelapse=True, "
          f"timelapse_type='as_is')) on DEFAULT_RING: kept "
          f"{len(res.kept_indices)}/{N_IMAGES}, reprojection {err:.4f} px, "
          f"{len(frames)} frames fixed_*.jpg of the union canvas {cw}x{ch} "
          f"in the working directory, no result.jpg, launches {launches}, "
          f"wall {wall:.4f} s; Compositing "
          f"{res.stage_times['Compositing']:.4f} s (loop) against phase 9b's "
          f"{base_9b.stage_times['Compositing']:.4f} s (fused); card "
          f"'{smi}'", flush=True)
    del res, rec

    # (c) spher16 with the auto-crop, timed after a warm-up on its twin.
    cfg = StitchConfig(crop_result=True)
    g = SPHER16
    stitch(caps12["spher16 warm-up"], cfg, output="", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = Recorder(stitcher, "fused_compose")
    with HostTimer(stitcher, "crop_rect") as crop_t:
        res, wall, launches = stitch_run(stitch, caps12["spher16"], cfg,
                                         counters, rec)
    peak = torch.cuda.max_memory_allocated()
    assert res.kept_indices == list(range(g["n_images"])), res.kept_indices
    err = reproj_err_px(res.cameras, res.kept_indices, truth["k16"],
                        truth["rs16"], res.work_scale, g["hw"])
    assert err <= 1.0, f"spher16 reprojection {err:.4f} px > 1 px"
    pano = res.panorama
    assert bool(torch.isfinite(pano).all()), "non-finite panorama"
    canvas = tuple(res.mask.shape)
    assert pano.shape[0] * pano.shape[1] < canvas[0] * canvas[1], \
        (tuple(pano.shape), canvas)
    img8 = np.clip(pano.cpu().numpy(), 0, 255).astype(np.uint8)
    gray = (0.299 * img8[..., 0] + 0.587 * img8[..., 1] +
            0.114 * img8[..., 2])
    inner = crop.check_interior_exterior(
        np.where(gray > 0, np.uint8(255), np.uint8(0)),
        (0, 0, img8.shape[1], img8.shape[0]))
    assert inner[0], f"the cropped panorama's border holds black: {inner}"
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    by_path["phase 12c"] = launches
    mp_in = g["n_images"] * g["hw"][0] * g["hw"][1] / 1e6
    print(f"phase 12c spher16 (StitchConfig(crop_result=True), "
          f"{g['n_images']} x {g['hw'][0]}x{g['hw'][1]}, 55 deg, overlap "
          f"{g['overlap_ratio']}, seed {g['seed']}, sigma-8 noise, after a "
          f"warm-up on its +-2 LSB twin): kept {len(res.kept_indices)}/"
          f"{g['n_images']}, reprojection {err:.4f} px, canvas {canvas} "
          f"cropped to {tuple(pano.shape)}, its border clean "
          f"(check_interior_exterior finished), crop's host time "
          f"{crop_t.seconds:.4f} s, launches {launches}, wall {wall:.4f} s "
          f"({mp_in / wall:.3f} MP/s, {mp_in:.2f} MP in), peak device "
          f"memory {peak / 2 ** 30:.3f} GiB ({peak} bytes); card '{smi}'\n"
          + stage_table([("phase 9b", base_9b.stage_times),
                         ("12a mixed8", mixed_stages),
                         ("12b timelapse", timelapse_stages),
                         ("12c spher16", res.stage_times)]), flush=True)
    del res, rec
    return dict(by_path=by_path, k2=k2, k5=k5)


# Phase 13's configurations, as the JAX package's bench.py makes them.
# mosaic100 (bench.py:378-442): 100 narrow-fov views with the detailed
# texture, the range matcher, BA's CG solver past 64 cameras, and its
# +-2 LSB warm-up twin.  gigapixel (bench.py:561-731): a 12 x 24 grid of
# 1024x1536 tiles at focal 6000 made on the device, seam-scale prep, then
# the strip-streamed compose of the 271.2 MP canvas.
MOSAIC100 = dict(n_images=100, hw=(480, 640), fov_deg=8.0,
                 overlap_ratio=0.55, seed=31)
MOSAIC_RANGE = 3
GIGAPIXEL = dict(rows=12, cols=24, hw=(1024, 1536), focal=6000.0,
                 overlap=0.25, strip_w=4096, chunk=48, seeds=(1, 2))
# Beside the strip compose's terms in 13c's memory gate: the allocator's
# rounding and the small tensors (rect grids, offsets, events).
MEM_SLACK = 128 * 2 ** 20


def render_phase13_dirs(root: str, workers: int):
    """mosaic100 and its warm-up twin, rendered in one process pool:
    ({name: directory}, ground truth)."""
    import multiprocessing as mp
    from image_stitching_tpu_torch.data.synth import (make_ring_captures,
                                                      write_capture_dir)
    dirs = {name: os.path.join(root, name.replace(" ", "_"))
            for name in ("mosaic100", "mosaic100 warm-up")}
    with mp.get_context("spawn").Pool(workers) as pool:
        images, k, rs = make_ring_captures(texture_detail=True, pool=pool,
                                           **MOSAIC100)
    write_capture_dir(dirs["mosaic100"], images, k, rs)
    write_capture_dir(dirs["mosaic100 warm-up"], noisy_twin(images), k, rs)
    return dirs, dict(k=np.asarray(k, np.float64),
                      rs=[np.asarray(r, np.float64) for r in rs])


def gigapixel_geometry():
    """bench.py's gigapixel cameras, compose ROIs and seam-scale ROIs."""
    from scipy.spatial.transform import Rotation
    from image_stitching_tpu_torch.ops.warps import make_warper, result_roi
    g = GIGAPIXEL
    (h, w), focal = g["hw"], g["focal"]
    n = g["rows"] * g["cols"]
    yaw = (w / focal) * (1 - g["overlap"])
    pitch = (h / focal) * (1 - g["overlap"])
    k = np.tile(np.array([[focal, 0, w / 2], [0, focal, h / 2],
                          [0, 0, 1]], np.float32), (n, 1, 1))
    rs = np.stack([
        (Rotation.from_euler("y", yaw * (c - (g["cols"] - 1) / 2))
         * Rotation.from_euler("x", pitch * (r - (g["rows"] - 1) / 2))
         ).as_matrix().astype(np.float32)
        for r in range(g["rows"]) for c in range(g["cols"])])
    warper = make_warper("spherical", focal)
    rois = [warper.warp_roi((h, w), k[i], rs[i]) for i in range(n)]
    s = min(1.0, float(np.sqrt(0.1e6 / (h * w))))
    seam_hw = (int(round(h * s)), int(round(w * s)))
    k_seam = k.copy()
    k_seam[:, 0, :] *= s
    k_seam[:, 1, :] *= s
    warper_s = make_warper("spherical", focal * s)
    srois = [warper_s.warp_roi(seam_hw, k_seam[i], rs[i]) for i in range(n)]
    return dict(n=n, k=k, rs=rs, warper=warper, warper_s=warper_s, s=s,
                seam_hw=seam_hw, k_seam=k_seam, srois=srois,
                corners=[(r[0], r[1]) for r in rois],
                sizes=[(r[2], r[3]) for r in rois],
                canvas=result_roi([(r[0], r[1]) for r in rois],
                                  [(r[2], r[3]) for r in rois]))


def gigapixel_tiles(seed: int, n: int, dev):
    """bench.py's tiles on the device: uniform [0, 256) from one CUDA
    generator, 48 tiles at a time, times the tile's gain
    0.75 + 0.5 cos(0.37 i), clipped, as u8."""
    h, w = GIGAPIXEL["hw"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gain = 0.75 + 0.5 * np.cos(np.arange(n) * 0.37)
    tiles = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
    for c0 in range(0, n, GIGAPIXEL["chunk"]):
        m = min(GIGAPIXEL["chunk"], n - c0)
        t = torch.rand((m, h, w, 3), generator=gen, device=dev) * 256.0
        g = torch.as_tensor(gain[c0:c0 + m, None, None, None],
                            dtype=torch.float32, device=dev)
        tiles[c0:c0 + m] = torch.clamp(t * g, 0.0, 255.0).to(torch.uint8)
        del t
    return tiles


def gigapixel_prep(tiles, geo, dev):
    """The seam-scale prep of bench.py's gigapixel: each tile resized to
    seam scale, warp_stack, GAIN_BLOCKS (block 64) by feed_device, DP
    colour seams.  Returns (compensator, seam masks, exposure s, seams s),
    the exposure seconds including the resize and warp."""
    from image_stitching_tpu_torch.config import ExposureCompensatorType
    from image_stitching_tpu_torch.ops.exposure import feed_device
    from image_stitching_tpu_torch.ops.imgproc import resize
    from image_stitching_tpu_torch.ops.seams import find_seams
    from image_stitching_tpu_torch.ops.warps import u_period
    from image_stitching_tpu_torch.pipeline.compose_fused import warp_stack
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seam = torch.stack([torch.clamp(torch.round(resize(im, geo["seam_hw"])),
                                    0, 255).to(torch.uint8) for im in tiles])
    srois = geo["srois"]
    images_pad, masks_pad = warp_stack(
        seam, torch.as_tensor(geo["k_seam"], device=dev),
        torch.as_tensor(geo["rs"], device=dev), geo["warper_s"].scale,
        torch.as_tensor(np.asarray([[r[0], r[1]] for r in srois],
                                   np.float32), device=dev), "spherical",
        pad_h=-(-max(r[3] for r in srois) // 64) * 64,
        pad_w=-(-max(r[2] for r in srois) // 64) * 64)
    masks_host = masks_pad.cpu().numpy()
    masks_warped = [masks_host[i, :r[3], :r[2]] for i, r in enumerate(srois)]
    period = u_period("spherical", geo["warper_s"].scale)
    corners = [(r[0], r[1]) for r in srois]
    comp = feed_device(corners, [(r[2], r[3]) for r in srois], images_pad,
                       masks_pad,
                       comp_type=ExposureCompensatorType.GAIN_BLOCKS,
                       block_size=64, period=period)
    torch.cuda.synchronize()
    t_exp = time.perf_counter() - t0
    t0 = time.perf_counter()
    seam_masks = find_seams(corners, masks_warped, "dp_color",
                            images_dev=images_pad, period=period)
    torch.cuda.synchronize()
    return comp, seam_masks, t_exp, time.perf_counter() - t0


def k5_chunk_bound(warped, offs, accs, nb):
    """K5's bound on one call: phase 7's bytes (`k5_union_bytes`) and per
    rect the pyrDown and band operations of `k5_loop_check`."""
    n, _, ph, pw = warped.shape
    n_bytes = k5_union_bytes((n, ph, pw), offs, accs, nb)
    n_ops = n * (sum(4 * 50 * (ph >> b) * (pw >> b) for b in range(1, nb + 1))
                 + sum((3 * 18 + 12) * (ph >> b) * (pw >> b)
                       for b in range(nb + 1)))
    return bound(n_bytes, n_ops)


def strip_kernel_check(dev, tiles, geo, comp, seam_masks, strips):
    """Phase 13d: K2 and K5 at one strip's shapes.  In the strip with the
    most rects, the first K5 call of its largest bucket (as many rects as
    SAMPLE_BUDGET holds) is made again by the compose's own code, its K2
    calls recorded: K2 against its plain version (phase 3's gate), K5 into
    fresh strip accumulators against its plain version (phase 7's gates);
    device, call and plain ms and the bounds, grid_sample beside K2."""
    import dataclasses
    from image_stitching_tpu_torch.kernels.multiband import (
        pyramid_accumulate, pyramid_accumulate_plain)
    from image_stitching_tpu_torch.kernels.warp_gather import (
        warp_bilinear, warp_bilinear_plain)
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    g = max(strips, key=lambda st: len(st.tls))
    (ph, pw), idxs = max(g.buckets.items(),
                         key=lambda kv: (kv[0][0] * kv[0][1], len(kv[1])))
    per = max(1, cf.SAMPLE_BUDGET // cf._rect_bytes(ph, pw, g.n_bands))
    g_one = dataclasses.replace(g, buckets={(ph, pw): idxs[:per]})
    rec = Recorder(cf, "warp_bilinear")
    with rec:
        warped, weight, offs = next(iter(cf.compose_buckets(
            tiles, geo["k"], geo["rs"], geo["warper"], geo["corners"],
            geo["sizes"], seam_masks, [(r[0], r[1]) for r in geo["srois"]],
            geo["s"], comp, g_one)))
    calls = [args for args, _, _ in rec.calls["warp_bilinear"]]
    assert len(calls) == warped.shape[0], (len(calls), warped.shape)
    k2_err = k2_max_diff(calls)

    def run2(fn):
        for src, sx, sy in calls:
            fn(src, sx, sy)
    k2_bound_ms, k2_bound_by = k2_bound(calls)
    k2 = dict(err=k2_err, rects=[tuple(c[1].shape) for c in calls],
              device_ms=device_ms(lambda: run2(warp_bilinear), reps=5,
                                  replays=3) / len(calls),
              call_ms=time_ms(lambda: run2(warp_bilinear), reps=5)
              / len(calls),
              plain_ms=time_ms(lambda: run2(warp_bilinear_plain), reps=1)
              / len(calls),
              library_ms=k2_library_ms(calls)[0], bound_ms=k2_bound_ms,
              bound_by=k2_bound_by)
    del calls, rec
    nb = g.n_bands

    def fresh():
        return [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b),
                            device=dev) for b in range(nb + 1)]
    acc_k, acc_p = fresh(), fresh()
    pyramid_accumulate(warped, weight, offs, acc_k, nb)
    pyramid_accumulate_plain(warped, weight, offs, acc_p, nb)
    err, u8 = _k5_gates(acc_k, acc_p, nb, "strip")
    del acc_p
    scratch = acc_k
    launches = kernel_launches(
        lambda: pyramid_accumulate(warped, weight, offs, scratch, nb))
    assert launches <= 2 * nb + 1, f"K5 strip: {launches} launches a call"
    k5_bound_ms, k5_bound_by = k5_chunk_bound(warped, offs, scratch, nb)
    k5 = dict(err=err, u8=u8, n_bands=nb, launches_per_call=launches,
              chunk=tuple(warped.shape), bucket=len(idxs),
              accs=tuple(scratch[0].shape),
              device_ms=device_ms(lambda: pyramid_accumulate(
                  warped, weight, offs, scratch, nb), reps=3, replays=2),
              call_ms=time_ms(lambda: pyramid_accumulate(
                  warped, weight, offs, scratch, nb), reps=3),
              plain_ms=time_ms(lambda: pyramid_accumulate_plain(
                  warped, weight, offs, scratch, nb), reps=1),
              bound_ms=k5_bound_ms, bound_by=k5_bound_by)
    return k2, k5


class FirstCall:
    """While open, keeps the args and kwargs of the first call of
    `module.name` (later calls pass through unkept)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = self.kwargs = None

    def __enter__(self):
        def first(*args, **kwargs):
            if self.args is None:
                self.args, self.kwargs = args, kwargs
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, first)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class StripWatch:
    """While open, what the strip compose holds, read from the compose
    itself: the finished strips left on the device after each hand-off to
    the download (`_StripFetch.put`), and each K5 call's rects and device
    bytes of samples and scratch (`_rect_bytes`)."""

    def __init__(self):
        from image_stitching_tpu_torch.pipeline import compose_fused as cf
        self.cf, self.pending, self.chunks = cf, [], []
        self.put, self.pa = cf._StripFetch.put, cf.pyramid_accumulate

    def __enter__(self):
        cf = self.cf

        def put(fetch, *args):
            self.put(fetch, *args)
            self.pending.append(len(fetch.pending))

        def pa(warped, weight, offs, accs, nb):
            n, _, ph, pw = warped.shape
            self.chunks.append((n, n * cf._rect_bytes(ph, pw, nb)))
            return self.pa(warped, weight, offs, accs, nb)
        cf._StripFetch.put = put
        cf.pyramid_accumulate = pa
        return self

    def __exit__(self, *exc):
        self.cf._StripFetch.put = self.put
        self.cf.pyramid_accumulate = self.pa


def hist_percentile(counts, q: float) -> float:
    """np.percentile's (linear) q-th percentile of the integers 0, 1, ...
    that occur counts[v] times."""
    cum = np.cumsum(np.asarray(counts, np.int64))
    n = int(cum[-1])
    r = q / 100.0 * (n - 1)
    i = int(np.floor(r))
    lo = int(np.searchsorted(cum, i, side="right"))
    hi = int(np.searchsorted(cum, min(i + 1, n - 1), side="right"))
    return lo + (r - i) * (hi - lo)


def u8_diff_stats(pano_a, pano_b, mask):
    """|a - b| of two u8-valued (H, W, 3) device panoramas over the mask:
    (mean, p99, max), from the exact histogram of the integer
    differences."""
    d = (pano_a.to(torch.int16) - pano_b.to(torch.int16)).abs_()
    d = torch.where(mask[..., None], d, torch.full_like(d, -1))
    vmax = int(d.max())
    counts = [int((d == v).sum()) for v in range(vmax + 1)]
    n = sum(counts)
    mean = sum(v * c for v, c in enumerate(counts)) / n
    return mean, hist_percentile(counts, 99.0), vmax


def big_diff_sites(pano_a, pano_b, mask, cuts, top: int = 3):
    """Where two u8-valued (H, W, 3) panoramas differ by more than 2 over
    the mask: the count of such pixels, their count by distance in
    columns to the nearest of `cuts` (the strip boundaries and canvas
    edges), and the `top` largest as (row, column, |diff|, share of the
    mask in their 5x5 window)."""
    d = (pano_a.to(torch.int16) - pano_b.to(torch.int16)).abs_().amax(-1)
    d = torch.where(mask, d, torch.zeros_like(d))
    xs = torch.nonzero(d > 2, as_tuple=True)[1]
    dist = (xs[:, None] - torch.as_tensor(cuts, device=d.device)[None]
            ).abs().amin(1)
    edges = [0, 64, 256, 512, 1024, 2048, 1 << 30]
    by_dist = {f"{a}-{b}" if b < 1 << 30 else f">={a}":
               int(((dist >= a) & (dist < b)).sum())
               for a, b in zip(edges, edges[1:])}
    vals, idx = torch.topk(d.flatten(), top)
    sites = []
    for v, i in zip(vals.tolist(), idx.tolist()):
        y, x = divmod(i, d.shape[1])
        win = mask[max(0, y - 2):y + 3, max(0, x - 2):x + 3]
        sites.append((y, x, v, round(float(win.float().mean()), 2)))
    return int(xs.numel()), by_dist, sites


def banded_up_check(dev, frame_hw, nb: int, what: str):
    """The collapse's pyrUp on the card at every level of a (h, w) frame
    whose output has an axis above the dense threshold: the banded
    `pyr_up_mm` against the dense matrices (`_up_mat_np`, built here
    without its cache) on the same random band, under the CPU tests'
    rtol 1e-5 / atol 1e-4.  Returns (max |diff|, output levels checked)."""
    from image_stitching_tpu_torch.ops import pyr_mat
    h, w = frame_hw
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err, levels = 0.0, []
    for b in range(nb, 0, -1):
        in_hw, out_hw = (h >> b, w >> b), (h >> (b - 1), w >> (b - 1))
        if max(out_hw) <= pyr_mat._T_DENSE:
            continue
        x = torch.rand((3,) + in_hw, generator=gen, device=dev) * 255.0
        got = pyr_mat.pyr_up_mm(x, out_hw)
        uh, uw = (torch.as_tensor(pyr_mat._up_mat_np.__wrapped__(o, i),
                                  device=dev)
                  for o, i in zip(out_hw, in_hw))
        want = uh @ x @ uw.t()
        del uh, uw
        excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
        assert excess <= 1e-4, \
            f"banded pyrUp {what} {in_hw} -> {out_hw}: {excess} past 1e-5 rel"
        err = max(err, float((got - want).abs().max()))
        levels.append(b - 1)
        del x, got, want
    torch.cuda.empty_cache()
    return err, levels


def strip_memory_terms(tiles, geo, comp, seam_masks, strips):
    """The device bytes the strip compose holds at most beside the tile
    stack: its per-image inputs (`_sample_inputs`: dilated seam masks,
    gains, cameras; measured), one strip's accumulators, SAMPLE_BUDGET
    (one K5 call's samples and scratch), one rect's sample with its
    temporaries (the largest rect sampled alone; measured) and two
    finished strips (u8 and mask)."""
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    inp = cf._sample_inputs(tiles, geo["k"], geo["rs"], geo["warper"],
                            geo["corners"], geo["sizes"], seam_masks,
                            [(r[0], r[1]) for r in geo["srois"]], geo["s"],
                            comp)
    torch.cuda.synchronize()
    inputs = torch.cuda.memory_allocated() - base
    g = max(strips, key=lambda st: max(ph * pw for ph, pw in st.buckets))
    (ph, pw), idxs = max(g.buckets.items(), key=lambda kv: kv[0][0] * kv[0][1])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sample = cf._rect_sample(inp, g, idxs[0], ph, pw)
    torch.cuda.synchronize()
    rect = torch.cuda.max_memory_allocated() - base
    del sample, inp
    torch.cuda.empty_cache()
    nb = strips[0].n_bands
    ch = strips[0].canvas[3]
    strip_w = strips[1].canvas[0] - strips[0].canvas[0] if len(strips) > 1 \
        else strips[0].canvas_w
    return dict(inputs=inputs, rect=rect, rect_hw=(ph, pw),
                strip_accs=sum(16 * (strips[0].canvas_h >> b)
                               * (strips[0].canvas_w >> b)
                               for b in range(nb + 1)),
                budget=cf.SAMPLE_BUDGET, downloads=2 * ch * strip_w * 4)


def strips_vs_whole(tiles, geo, comp, seam_masks, pano, mask, margin,
                    strip_w, dev):
    """Phase 13c's strips against the whole-canvas compose on the same
    tiles, gains and seams: `fused_compose` (its time and peak device
    memory), its mask equal to the strips', |diff| over the mask within
    phase 13a's gates: mean < 0.5 over the whole mask, p99 <= 2 right of
    the first `margin` columns.  There the reference's bucket clamp pulls
    the first strip's rects past the canvas's left edge, so its pyramid
    meets zero-weight columns where the whole canvas's reflects: the JAX
    package's own strips differ from its `fused_compose` there (2 x 4
    tiles of 128x192 at 4 bands: columns 0-8 above 2, p99 5 over the
    mask), and the port's equal the JAX strips within 1.  That zone's
    numbers and where the differences above 2 lie are printed."""
    from image_stitching_tpu_torch.config import BlenderType
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pano_w, mask_w = cf.fused_compose(
        tiles, geo["k"], geo["rs"], geo["warper"], geo["corners"],
        geo["sizes"], seam_masks, [(r[0], r[1]) for r in geo["srois"]],
        geo["s"], comp, BlenderType.MULTI_BAND, 5.0)
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    mask_s = torch.from_numpy(mask).to(dev)
    assert torch.equal(mask_w, mask_s), "13c: strip mask differs from the " \
        f"whole canvas's ({int((mask_w != mask_s).sum())} px)"
    pano_s = torch.from_numpy(pano).to(dev)
    mean, p99_all, vmax = u8_diff_stats(pano_w, pano_s, mask_w)
    _, p99, vmax_in = u8_diff_stats(pano_w[:, margin:], pano_s[:, margin:],
                                    mask_w[:, margin:])
    edge = u8_diff_stats(pano_w[:, :margin], pano_s[:, :margin],
                         mask_w[:, :margin])
    cw = mask_w.shape[1]
    sites = big_diff_sites(pano_w, pano_s, mask_w,
                           list(range(0, cw, strip_w)) + [cw])
    assert mean < 0.5 and p99 <= 2.0, (mean, p99)
    del pano_w, mask_w, mask_s, pano_s
    torch.cuda.empty_cache()
    return dict(t_whole=t_whole, peak=peak, mean=mean, p99=p99,
                max=vmax_in, p99_all=p99_all, max_all=vmax, edge=edge,
                sites=sites)


def run_phase13(stitch, counters, names, caps13, truth, caps_default,
                base_9b, work, smi, dev):
    """Phase 13, the strip-streamed compose and bench.py's mosaic100 and
    gigapixel: (a) StitchConfig() on DEFAULT_RING with compose_strips_mp
    below its canvas, against phase 9b's panorama; (b) mosaic100 after a
    warm-up on its twin, with K1 on its first launch, K2 and K5 on its
    compose, K4 on its 197 pairs and the banded pyrUp of its collapse;
    (c) gigapixel's 271.2 MP compose from 288 device tiles after a warm
    pass: one finished strip left on the device after each hand-off, K5
    calls within SAMPLE_BUDGET, the peak device memory within the
    design's terms and below the whole-canvas accumulators, the panorama
    against the whole-canvas compose, the banded pyrUp of a strip's
    collapse; (d) K2 and K5 at one strip's shapes.  Each stitch and the
    timed compose run under the counts as in phase 9.  Returns the counts
    by path and the kernel numbers."""
    from image_stitching_tpu_torch.config import BlenderType, StitchConfig
    from image_stitching_tpu_torch.ops.features import orb as orb_mod
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    from image_stitching_tpu_torch.pipeline import stitcher
    by_path = {}

    # (a) The strip dispatch through stitch(): 9b's captures and
    # configuration with the strips switched on below its canvas.
    ch9, cw9 = tuple(base_9b.mask.shape)
    mp_9b = ch9 * cw9 / 1e6
    cfg = StitchConfig(compose_strips_mp=round(mp_9b / 2, 3),
                       compose_strip_w=cw9 // 4)
    rec = Recorder(stitcher, "fused_compose", "fused_compose_strips")
    res, wall, launches = stitch_run(stitch, caps_default, cfg, counters, rec)
    assert rec.calls["fused_compose"] == [], "the whole-canvas compose ran"
    (args, kwargs, _), = rec.calls["fused_compose_strips"]
    strip_w, margin, strips = cf.strip_rects(args[4], args[5], args[10],
                                             args[11], kwargs["strip_w"])
    assert len(strips) >= 3, len(strips)
    assert res.panorama.device.type == "cpu", res.panorama.device
    mask_9b = base_9b.mask.cpu()
    assert torch.equal(res.mask, mask_9b), "13a: mask differs from 9b's"
    diff = (res.panorama - base_9b.panorama.cpu()).abs()[mask_9b].numpy()
    mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
    assert mean < 0.5 and p99 <= 2.0, (mean, p99)
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    by_path["phase 13a"] = launches
    print(f"phase 13a strips through stitch() (StitchConfig(compose_strips_mp"
          f"={cfg.compose_strips_mp}, compose_strip_w={cfg.compose_strip_w})"
          f" on DEFAULT_RING, canvas {ch9}x{cw9} = {mp_9b:.3f} MP): "
          f"{len(strips)} strips of {strip_w} columns, margin {margin}, "
          f"{strips[0].n_bands} bands, rects per strip "
          f"{[len(st.tls) for st in strips]}; panorama on the host, mask "
          f"equal to 9b's, |diff| over the mask mean {mean:.4f} (< 0.5), "
          f"p99 {p99:.1f} (<= 2); launches {launches}, wall {wall:.4f} s; "
          f"Compositing {res.stage_times['Compositing']:.4f} s against 9b's "
          f"{base_9b.stage_times['Compositing']:.4f} s; card '{smi}'",
          flush=True)
    del res, rec, args

    # (b) mosaic100, timed after a warm-up on its +-2 LSB twin; the timed
    # stitch's first K1 launch and its compose call are kept for the
    # kernels at its shapes.
    m = MOSAIC100
    cfg = StitchConfig(range_width=MOSAIC_RANGE,
                       checkpoint_dir=os.path.join(work, "mosaic100_run"))
    os.makedirs(cfg.checkpoint_dir)
    stitch(caps13["mosaic100 warm-up"], cfg, output="", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = Recorder(stitcher, "match_all_pairs", "fused_compose")
    with FirstCall(orb_mod, "orb_sample_levels") as k1_call:
        res, wall, launches = stitch_run(stitch, caps13["mosaic100"], cfg,
                                         counters, rec)
    peak = torch.cuda.max_memory_allocated()
    assert res.kept_indices == list(range(m["n_images"])), res.kept_indices
    err = reproj_err_px(res.cameras, res.kept_indices, truth["k"],
                        truth["rs"], res.work_scale, m["hw"])
    assert err <= 1.0, f"mosaic100 reprojection {err:.4f} px > 1 px"
    assert bool(torch.isfinite(res.panorama).all()), "non-finite panorama"
    for name in names:
        assert launches[name] > 0, f"{name} was not launched by the path"
    by_path["phase 13b"] = launches
    mp_in = m["n_images"] * m["hw"][0] * m["hw"][1] / 1e6
    cov = float(res.mask.float().mean())
    print(f"phase 13b mosaic100 (StitchConfig(range_width={MOSAIC_RANGE}), "
          f"{m['n_images']} x {m['hw'][0]}x{m['hw'][1]}, fov "
          f"{m['fov_deg']} deg, overlap {m['overlap_ratio']}, seed "
          f"{m['seed']}, detailed texture, after a warm-up on its +-2 LSB "
          f"twin): kept {len(res.kept_indices)}/{m['n_images']}, "
          f"reprojection {err:.4f} px, canvas {tuple(res.mask.shape)} "
          f"(mask {cov:.4f}), launches {launches}, wall {wall:.4f} s "
          f"({mp_in / wall:.3f} MP/s, {mp_in:.2f} MP in), peak device "
          f"memory {peak / 2 ** 30:.3f} GiB ({peak} bytes); card '{smi}'\n"
          + stage_table([("phase 9b", base_9b.stage_times),
                         ("13b mosaic100", res.stage_times)]), flush=True)
    feats = rec.calls["match_all_pairs"][0][0][0]
    k4_in = k4_args(dev, feats, MOSAIC_RANGE)
    k4 = dict(k4_times(k4_in, feats.valid), pairs=len(k4_in[2]))
    print(f"phase 13b K4 on mosaic100's descriptors: {k4['pairs']} pairs "
          f"(range {MOSAIC_RANGE}) of K={feats.xy.shape[1]}, both "
          f"directions, one call: equal to the plain version; device "
          f"{k4['dev_ms']:.4f} ms, call {k4['call_ms']:.4f} ms, plain "
          f"{k4['plain_ms']:.4f} ms; bound over {k4['n_dist']:.0f} valid "
          f"distances {k4['bound_ms']:.4f} ms ({k4['route']}; CUDA cores "
          f"{k4['cuda_core_ms']:.4f} ms), {k4['bound_ms'] / k4['dev_ms']:.1%}"
          f" of it reached", flush=True)
    raws = k1_call.args[0]
    valid = torch.bincount(feats.octave[0][feats.valid[0]].long(),
                           minlength=len(raws)).tolist()
    k1, _ = k1_launch_check(
        dev, *k1_call.args[:5], valid, "13b", "orb_sample_levels",
        "image_stitching_tpu/kernels/orb_sample_pallas.py:145")
    print(f"phase 13b K1 on the stitch's first launch (view 0, K="
          f"{k1_call.args[2].shape[0]}, valid {sum(valid)}): equal to the "
          f"plain version under phase 2's gates; "
          f"{launches['orb_sample_levels']} launches a stitch", flush=True)
    del res, feats, k4_in, k1_call, raws
    compose_call = rec.calls["fused_compose"][0]
    calls, g_m = compose_k2_calls(compose_call)
    k2 = k2_loop_check(calls)
    print(f"phase 13b K2 on mosaic100's {len(calls)} compose rects "
          f"{sorted({tuple(c[1].shape) for c in calls})} (sources "
          f"{sorted({tuple(c[0].shape) for c in calls})}): max |diff| "
          f"{k2['err']:.3g} (atol 1e-4), per rect: kernel device "
          f"{k2['device_ms']:.4f} ms, call {k2['call_ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, grid_sample device "
          f"{k2['library_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2['bound_by']}, {k2['bound_ms'] / k2['device_ms']:.1%} of it "
          f"reached); {launches['warp_bilinear']} launches a stitch",
          flush=True)
    del calls
    k5 = k5_compose_check(dev, compose_call, "mosaic100", plain=True)
    print(f"phase 13b K5 on mosaic100's compose calls {k5['buckets']} "
          f"({k5['n_bands']} bands, accumulators {k5['accs']}): accumulators"
          f" {k5['err']:.3g} (tol 2e-3), finalized u8 {k5['u8']} (tol 1), "
          f"masks equal, {k5['launches_per_call']:g} kernel launches a call;"
          f" per call: kernel device {k5['device_ms']:.4f} ms, call "
          f"{k5['call_ms']:.4f} ms, plain {k5['plain_ms']:.4f} ms, bound "
          f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}, "
          f"{k5['bound_ms'] / k5['device_ms']:.1%} of it reached); "
          f"{launches['pyramid_accumulate']} calls a stitch", flush=True)
    del compose_call, rec
    torch.cuda.empty_cache()
    mosaic = dict(k1=k1, k2=k2, k5=k5)
    band_err, band_lv = banded_up_check(dev, (g_m.canvas_h, g_m.canvas_w),
                                        g_m.n_bands, "mosaic100")
    print(f"phase 13b banded pyrUp of mosaic100's collapse ({g_m.n_bands} "
          f"bands, frame {g_m.canvas_h}x{g_m.canvas_w}) at output levels "
          f"{band_lv}: against the dense matrices max |diff| {band_err:.3g}"
          f" (rtol 1e-5, atol 1e-4)", flush=True)

    # (c) gigapixel: a warm pass on seed 1, the timed pass on seed 2.
    geo = gigapixel_geometry()
    gp = GIGAPIXEL
    cx, cy, cw, ch = geo["canvas"]
    canvas_mp = cw * ch / 1e6
    seam_corners = [(r[0], r[1]) for r in geo["srois"]]
    strip_w, margin, strips = cf.strip_rects(
        geo["corners"], geo["sizes"], BlenderType.MULTI_BAND, 5.0,
        gp["strip_w"])
    g_whole = cf.compose_rects(geo["corners"], geo["sizes"],
                               BlenderType.MULTI_BAND, 5.0)
    nb = strips[0].n_bands

    def pass_(seed):
        tiles = gigapixel_tiles(seed, geo["n"], dev)
        comp, seam_masks, t_exp, t_seam = gigapixel_prep(tiles, geo, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with StripWatch() as watch:
            pano, mask = cf.fused_compose_strips(
                tiles, geo["k"], geo["rs"], geo["warper"], geo["corners"],
                geo["sizes"], seam_masks, seam_corners, geo["s"], comp,
                BlenderType.MULTI_BAND, 5.0, strip_w=gp["strip_w"],
                out_dtype=np.uint8)
            torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        return dict(tiles=tiles, comp=comp, seam_masks=seam_masks,
                    t_exp=t_exp, t_seam=t_seam, t_comp=t_comp, pano=pano,
                    mask=mask, peak=torch.cuda.max_memory_allocated(),
                    watch=watch, resident=resident,
                    launches={fn.__name__: fn.launches for fn in counters})

    warm = pass_(gp["seeds"][0])
    warm_s = (warm["t_exp"], warm["t_seam"], warm["t_comp"])
    del warm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = pass_(gp["seeds"][1])
    t_e2e = time.perf_counter() - t0
    pano, mask, peak = run["pano"], run["mask"], run["peak"]
    assert pano.shape == (ch, cw, 3) and pano.dtype == np.uint8, \
        (pano.shape, pano.dtype)
    cov = float(mask.mean())
    assert cov > 0.5, f"gigapixel mask coverage {cov:.4f}"
    level = float(pano[mask].mean())
    assert 8.0 < level < 248.0, f"gigapixel panorama mean {level:.2f}"
    # The rolling download and the sample budget, from the compose itself;
    # then the peak against the terms the design allows.
    watch = run["watch"]
    assert len(watch.pending) == len(strips) and max(watch.pending) <= 1, \
        f"finished strips left on the device after each hand-off: " \
        f"{watch.pending}"
    over = [c for c in watch.chunks if c[0] > 1 and c[1] > cf.SAMPLE_BUDGET]
    assert not over, f"K5 calls past SAMPLE_BUDGET: {over}"
    tile_bytes = run["tiles"].numel()
    whole_accs = sum(16 * (g_whole.canvas_h >> b) * (g_whole.canvas_w >> b)
                     for b in range(g_whole.n_bands + 1))
    terms = strip_memory_terms(run["tiles"], geo, run["comp"],
                               run["seam_masks"], strips)
    allowed = run["resident"] + sum(terms[k] for k in (
        "inputs", "strip_accs", "budget", "rect", "downloads")) + MEM_SLACK
    assert peak <= allowed, f"compose peak {peak} > {allowed} ({terms})"
    assert peak < tile_bytes + whole_accs, \
        f"compose peak {peak} >= tiles {tile_bytes} + whole {whole_accs}"
    launches = run["launches"]
    for name in ("warp_bilinear", "pyramid_accumulate"):
        assert launches[name] > 0, f"{name} was not launched by the compose"
    by_path["phase 13c"] = launches
    gb = 1e9
    print(f"phase 13c gigapixel ({gp['rows']} x {gp['cols']} tiles of "
          f"{gp['hw'][0]}x{gp['hw'][1]}, focal {gp['focal']}, overlap "
          f"{gp['overlap']}, made on the device from a CUDA generator "
          f"seeded {gp['seeds'][1]} after a warm pass on "
          f"{gp['seeds'][0]}): canvas {ch}x{cw} = {canvas_mp:.1f} MP, "
          f"{nb} bands, {len(strips)} strips of {strip_w} (margin {margin}, "
          f"accumulators {strips[0].canvas_h}x{strips[0].canvas_w}), rects "
          f"per strip {[len(st.tls) for st in strips]}; exposure "
          f"{run['t_exp']:.3f} s (resize, warp_stack, feed_device), seams "
          f"{run['t_seam']:.3f} s, compose {run['t_comp']:.3f} s "
          f"({canvas_mp / run['t_comp']:.2f} canvas MP/s, the download "
          f"included), e2e {t_e2e:.3f} s (warm pass: exposure "
          f"{warm_s[0]:.3f}, seams {warm_s[1]:.3f}, compose "
          f"{warm_s[2]:.3f} s); mask coverage {cov:.4f}, panorama mean "
          f"{level:.2f} over it; launches {launches}; finished strips on "
          f"the device after each hand-off {watch.pending}, K5 calls' rects "
          f"{sorted({c[0] for c in watch.chunks})} (largest "
          f"{max(c[1] for c in watch.chunks) / gb:.3f} GB of samples and "
          f"scratch, budget {cf.SAMPLE_BUDGET / gb:.3f}); compose peak "
          f"device memory {peak / gb:.3f} GB ({peak} bytes), gate: at most "
          f"what was resident before it {run['resident'] / gb:.3f} (tiles "
          f"{tile_bytes / gb:.3f}) + inputs {terms['inputs'] / gb:.3f}"
          f" + one strip's accumulators {terms['strip_accs'] / gb:.3f} + "
          f"sample budget {terms['budget'] / gb:.3f} + one rect "
          f"{terms['rect_hw']} with its temporaries {terms['rect'] / gb:.3f}"
          f" + two strip downloads {terms['downloads'] / gb:.3f} + slack "
          f"{MEM_SLACK / gb:.3f} = {allowed / gb:.3f} GB; whole-canvas "
          f"accumulators ({g_whole.canvas_h}x{g_whole.canvas_w}) "
          f"{whole_accs / gb:.3f} GB, tiles + them "
          f"{(tile_bytes + whole_accs) / gb:.3f} GB; card '{smi}'",
          flush=True)
    whole = strips_vs_whole(run["tiles"], geo, run["comp"],
                            run["seam_masks"], pano, mask, margin, strip_w,
                            dev)
    print(f"phase 13c strips against the whole-canvas compose "
          f"(fused_compose on the same tiles, gains and seams, "
          f"{whole['t_whole']:.3f} s on the device, peak "
          f"{whole['peak'] / gb:.3f} GB above what was resident): mask "
          f"equal, |diff| over the mask mean {whole['mean']:.4f} (< 0.5), "
          f"p99 {whole['p99_all']:.1f}, max {whole['max_all']}; right of "
          f"the first {margin} columns p99 {whole['p99']:.1f} (<= 2), max "
          f"{whole['max']}; in them (the first strip's rects pulled past the"
          f" canvas edge, as the reference's) mean {whole['edge'][0]:.4f}, "
          f"p99 {whole['edge'][1]:.1f}, max {whole['edge'][2]}; pixels "
          f"above 2: {whole['sites'][0]}, by columns to the nearest strip "
          f"boundary or canvas edge {whole['sites'][1]}, largest (row, col, "
          f"|diff|, mask share around) {whole['sites'][2]}", flush=True)
    del pano, mask
    band_err, band_lv = banded_up_check(
        dev, (strips[0].canvas_h, strips[0].canvas_w), nb, "gigapixel strip")
    print(f"phase 13c banded pyrUp of a strip's collapse ({nb} bands, frame "
          f"{strips[0].canvas_h}x{strips[0].canvas_w}) at output levels "
          f"{band_lv}: against the dense matrices max |diff| {band_err:.3g}"
          f" (rtol 1e-5, atol 1e-4)", flush=True)
    k2, k5 = strip_kernel_check(dev, run["tiles"], geo, run["comp"],
                                run["seam_masks"], strips)
    del run
    torch.cuda.empty_cache()
    print(f"phase 13d K2 on one strip's rects {k2['rects']} (sources "
          f"{gp['hw'][0]}x{gp['hw'][1]}x3): max |diff| {k2['err']:.3g} "
          f"(atol 1e-4), per rect: kernel device {k2['device_ms']:.4f} ms, "
          f"call {k2['call_ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, "
          f"grid_sample device {k2['library_ms']:.4f} ms, bound "
          f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}, "
          f"{k2['bound_ms'] / k2['device_ms']:.1%} of it reached)",
          flush=True)
    print(f"phase 13d K5 on one strip's K5 call {k5['chunk']} (of a bucket "
          f"of {k5['bucket']}, {k5['n_bands']} bands, accumulators "
          f"{k5['accs']}): accumulators {k5['err']:.3g} (tol 2e-3), "
          f"finalized u8 {k5['u8']} (tol 1), masks equal, "
          f"{k5['launches_per_call']} kernel launches; per call: kernel "
          f"device {k5['device_ms']:.4f} ms, call {k5['call_ms']:.4f} ms, "
          f"plain {k5['plain_ms']:.4f} ms, bound {k5['bound_ms']:.4f} ms "
          f"({k5['bound_by']}, {k5['bound_ms'] / k5['device_ms']:.1%} of it "
          f"reached)", flush=True)
    return dict(by_path=by_path, k4=k4, k2=k2, k5=k5, mosaic100=mosaic)


# Phase 14's detectors, with the CLI's match_conf rule (0.65 for the float
# descriptors, 0.32 for AKAZE's binary ones).
DETECTORS = ("sift", "surf", "akaze")
DETECTOR_MATCH_CONF = {"sift": 0.65, "surf": 0.65, "akaze": 0.32}
# On DEFAULT_RING the reference's near-duplicate rule (conf > 3 -> 0)
# zeroes every adjacent SIFT pair and two SURF pairs (ROADMAP fault (q)).
# The same views at this noise keep 8/8 with SURF's defaults and with
# SIFT at 1500 features (its raw confidences 2.45-2.99 there).
DETECTOR_RING_SIGMA = 12.0
DETECTOR_KEEP = {"sift": dict(num_features=1500), "surf": {}, "akaze": {}}


def detector_vs_cpu(feat, gray, got, n_features: int):
    """The detector on the card (`got`, the stitch's features of view 0)
    against the same module on the CPU on the same gray image: equal valid
    counts; each valid CPU keypoint paired with a card keypoint of the
    same octave within 1e-2 px and 1e-3 rad, at least 99% of them paired;
    at least 99% of the paired descriptors within 1e-4 (SIFT, SURF), or
    (AKAZE) with bits that differ only where the two means the bit
    compares differ by < 1e-3 on the CPU; the rest counted.  (SURF and
    AKAZE sample the nearest pixel of each rotated offset: an angle a few
    ulps apart can move a sample by one pixel.)  Returns the counts and
    the CPU seconds."""
    from image_stitching_tpu_torch.ops.features import (
        akaze, sift_detect_and_describe, surf_detect_and_describe)
    t0 = time.perf_counter()
    if feat == "akaze":
        ref, means = akaze.akaze_with_means(gray.cpu(), n_features)
    else:
        fn = (sift_detect_and_describe if feat == "sift"
              else surf_detect_and_describe)
        ref = fn(gray.cpu(), n_features)
    cpu_s = time.perf_counter() - t0
    got = type(got)(*(getattr(got, name).cpu() for name in (
        "xy", "response", "angle", "octave", "size", "desc", "valid")))
    n_ref, n_got = int(ref.valid.sum()), int(got.valid.sum())
    assert n_ref == n_got, f"{feat}: {n_got} valid on the card, {n_ref} CPU"
    ri = torch.nonzero(ref.valid)[:, 0]
    gi = torch.nonzero(got.valid)[:, 0]
    near = ((torch.abs(ref.xy[ri, None, 0] - got.xy[None, gi, 0]) <= 1e-2) &
            (torch.abs(ref.xy[ri, None, 1] - got.xy[None, gi, 1]) <= 1e-2) &
            (ref.octave[ri, None] == got.octave[None, gi]))
    turn = torch.remainder(ref.angle[ri, None].double() -
                           got.angle[None, gi].double() + np.pi,
                           2 * np.pi) - np.pi
    near &= torch.abs(turn) <= 1e-3
    paired = near.any(1)
    j = gi[near.to(torch.uint8).argmax(1)]
    same_slot = int((j == ri)[paired].sum())
    frac = float(paired.float().mean())
    assert frac >= 0.99, f"{feat}: {frac:.4f} of keypoints paired"
    rp, gp = ri[paired], j[paired]
    if feat == "akaze":
        chan, bi, bj = (torch.as_tensor(x) for x in akaze.bit_pairs())
        shifts = torch.arange(32, dtype=torch.int32)
        flips = (((ref.desc[rp][:, :, None] >> shifts) ^
                  (got.desc[gp][:, :, None] >> shifts)) & 1).reshape(
                      len(rp), -1)[:, :360].bool()
        gap = torch.abs(means[chan, :, bi] - means[chan, :, bj]).t()[rp]
        bad = flips & (gap >= 1e-3)
        ok = ~bad.any(1)
        desc_note = (f"{int(flips.sum())} bit flips in {len(rp) * 360} "
                     f"bits, {int(bad.sum())} of them where the compared "
                     f"means differ by >= 1e-3 (max "
                     f"{float(gap[flips].max()) if flips.any() else 0.0:.3g})")
    else:
        err = torch.abs(ref.desc[rp] - got.desc[gp]).amax(1)
        ok = err <= 1e-4
        turned = float(torch.abs(ref.angle[rp] - got.angle[gp]).max())
        desc_note = (f"descriptors max |diff| {float(err.max()):.3g}, "
                     f"{int((~ok).sum())} above 1e-4 (max angle difference "
                     f"{turned:.3g} rad)")
    frac_ok = float(ok.float().mean())
    assert frac_ok >= 0.99, f"{feat}: {desc_note}"
    return dict(valid=n_ref, paired=int(paired.sum()),
                unpaired=int((~paired).sum()), same_slot=same_slot,
                desc_note=desc_note, cpu_s=cpu_s)


def check_k4_words(dev, feats, what: str):
    """K4 at the stitch's own descriptor word count (AKAZE: 12): the +-1
    unpack against pm1_rows, every pair in both directions in one call
    against the plain version, a tie-heavy stack at the same K and word
    count, and the times and bound as phase 6 reckons them."""
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_pairs, hamming_two_nn_pairs_plain, pm1_rows,
        unpack_pm1)
    k, words = feats.xy.shape[1], feats.desc.shape[2]
    args = k4_args(dev, feats)
    assert torch.equal(unpack_pm1(args[0]), pm1_rows(args[0])), \
        f"K4's +-1 unpack at {words} words differs from pm1_rows"
    ties = _tie_stack(dev, k, words=words)
    _k4_equal(hamming_two_nn_pairs(*ties), hamming_two_nn_pairs_plain(*ties),
              f"tie case at {words} words")
    tm = k4_times(args, feats.valid)
    print(f"phase 14 K4 at {words} words ({32 * words} bits, {what}): "
          f"{len(args[2])} pairs of K={k}, both directions, in one call, "
          f"+-1 unpack equal to pm1_rows, i1/d1/d2 equal and i2 equal where "
          f"d2 < 2^30, the tie case equal; per call: device "
          f"{tm['dev_ms']:.4f} ms, call {tm['call_ms']:.4f} ms, plain "
          f"{tm['plain_ms']:.4f} ms; bound over {tm['n_dist']:.0f} valid "
          f"distances: CUDA cores {tm['cuda_core_ms']:.4f} ms, tensor cores "
          f"{tm['tensor_ms']:.4f} ms -> {tm['bound_ms']:.4f} ms "
          f"({tm['route']})", flush=True)
    return k4_row(f"{words} words: {what}", tm, words=words)


def near_duplicate_drops(graph, n: int):
    """The adjacent pairs (a, a + 1) a stitch's match graph zeroed, each
    with its raw confidence n_inliers / (8 + 0.3 n_matches); raises unless
    every one was zeroed by the reference's near-duplicate rule (raw > 3),
    the JAX package's `match_pair` as the port's."""
    raw = [float(graph.num_inliers[a, a + 1]) /
           (8.0 + 0.3 * float(graph.num_matches[a, a + 1]))
           for a in range(n - 1)]
    dropped = [(a, a + 1, round(r, 4)) for a, r in enumerate(raw)
               if float(graph.confidence[a, a + 1]) == 0.0]
    assert all(r > 3.0 for _, _, r in dropped), \
        f"adjacent pairs zeroed below the near-duplicate rule: {dropped}"
    return dropped, [round(r, 4) for r in raw]


def detector_stitch(stitch, stitcher, counters, caps, cfg):
    """One stitch() under the counts as in phase 9 with the detector,
    matching and seam calls recorded; the reference's "Need more images"
    is returned, not raised."""
    rec = Recorder(stitcher, "detect_features", "match_all_pairs",
                   "find_seams")
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with rec:
            res, failed = stitch(caps, cfg, output="", device="cuda"), None
    except RuntimeError as e:
        if not str(e).startswith("Need more images"):
            raise
        res, failed = None, str(e)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, failed, wall, {fn.__name__: fn.launches
                               for fn in counters}, rec


def run_phase14(stitch, stitcher, counters, caps_default, caps_noisy,
                k_true, rs_true, base_9b, smi, dev):
    """Phase 14, the other detectors: for each of sift, surf and akaze,
    StitchConfig(features_type=X, match_conf=0.65 for the float
    descriptors, 0.32 for AKAZE) on DEFAULT_RING, a warm-up stitch and a
    timed one under the counts as in phase 9, with K2 and K5 (and for
    AKAZE K4) launched and K1 not; its stage table, wall, MP/s and peak
    device memory.  Where the ring keeps 8/8 the stitch is held to phase
    9b's gates (<= 1 px, mask > 0.9, finite, seam union = warped union);
    where it does not (SIFT, SURF), every zeroed adjacent pair must be
    the reference's near-duplicate rule's (`near_duplicate_drops`; the
    JAX package's matching zeroes the same pairs on these features, ROADMAP
    fault (q)), the numbers are printed ungated, and the detector
    stitches DETECTOR_RING_SIGMA's ring under those gates with
    DETECTOR_KEEP's settings.  Then the detector on the card against the
    same module on the CPU on view 0 (`detector_vs_cpu`); for AKAZE, K4
    at 12 words on the stitch's own descriptors (`check_k4_words`);
    SIFT's peak device memory on one view.  Returns the counts by path
    and K4's 12-word row."""
    import dataclasses
    from image_stitching_tpu_torch.config import StitchConfig
    by_path, columns = {}, [("phase 9b orb", base_9b.stage_times)]
    k4_12 = None
    mp_in = N_IMAGES * H * W / 1e6

    def report(what, run, peak, names):
        """Print one stitch; hold it to the gates when it kept every
        image, else to the near-duplicate rule.  Returns whether gated."""
        res, failed, wall, launches, rec = run
        (feats, *_), _, graph = rec.calls["match_all_pairs"][0]
        dropped, raw = near_duplicate_drops(graph, N_IMAGES)
        assert launches["orb_sample_levels"] == 0, launches
        head = (f"{what}: descriptors {tuple(feats.desc.shape)} "
                f"{feats.desc.dtype}, valid per image "
                f"{feats.valid.sum(-1).tolist()}, adjacent pairs' n_inliers"
                f" / (8 + 0.3 n_matches) {raw}")
        if res is not None and res.kept_indices == list(range(N_IMAGES)):
            err, coverage, stages = e2e_gates(res, k_true, rs_true, launches,
                                              names, N_IMAGES, (H, W))
            covered, cut = seam_union_gate(rec.calls["find_seams"][0])
            print(f"{head}; kept {N_IMAGES}/{N_IMAGES}, reprojection "
                  f"{err:.4f} px, panorama {tuple(res.panorama.shape)}, mask "
                  f"{coverage:.4f}, seam union = warped union ({covered} px,"
                  f" {cut} px cut), launches {launches}, wall {wall:.4f} s "
                  f"({mp_in / wall:.3f} MP/s), peak device memory "
                  f"{peak / 2 ** 30:.3f} GiB ({peak} bytes), stages: "
                  f"{stages}; card '{smi}'", flush=True)
            columns.append((what, res.stage_times))
            return True
        assert dropped, f"{what} dropped images with no zeroed pair"
        if res is None:
            kept = f"the stitch stopped: '{failed}'"
        else:
            err = reproj_err_px(res.cameras, res.kept_indices, k_true,
                                rs_true, res.work_scale)
            kept = (f"kept {res.kept_indices}, reprojection {err:.4f} px, "
                    f"mask {float(res.mask.float().mean()):.4f}, stages: "
                    + ", ".join(f"{k}={v:.4f}s"
                                for k, v in res.stage_times.items()))
        print(f"{head}; pairs zeroed by the near-duplicate rule (raw > 3, "
              f"as the reference's matching zeroes them): {dropped}; "
              f"ungated: {kept}, launches {launches}, wall {wall:.4f} s, "
              f"peak device memory {peak / 2 ** 30:.3f} GiB; card '{smi}'",
              flush=True)
        return False

    for feat in DETECTORS:
        cfg = StitchConfig(features_type=feat,
                           match_conf=DETECTOR_MATCH_CONF[feat])
        names = ["warp_bilinear", "pyramid_accumulate"]
        if feat == "akaze":
            names.append("hamming_two_nn_pairs")
        detector_stitch(stitch, stitcher, counters, caps_default, cfg)
        torch.cuda.reset_peak_memory_stats()
        what = f"phase 14 {feat}"
        run = detector_stitch(stitch, stitcher, counters, caps_default, cfg)
        by_path[what] = run[3]
        rec = run[4]
        feats = rec.calls["match_all_pairs"][0][0][0]
        assert feats.desc.dtype == (torch.int32 if feat == "akaze"
                                    else torch.float32), feats.desc.dtype
        if not report(what, run, torch.cuda.max_memory_allocated(), names):
            keep = dataclasses.replace(cfg, **DETECTOR_KEEP[feat])
            what_k = (f"phase 14 {feat} sigma-{DETECTOR_RING_SIGMA:g} "
                      f"{DETECTOR_KEEP[feat]}")
            torch.cuda.reset_peak_memory_stats()
            run_k = detector_stitch(stitch, stitcher, counters, caps_noisy,
                                    keep)
            by_path[what_k] = run_k[3]
            assert report(what_k, run_k, torch.cuda.max_memory_allocated(),
                          names), f"{what_k} dropped images"
            del run_k
        grays = [args[0] for args, _, _ in rec.calls["detect_features"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stitcher.detect_stack(grays, cfg)
        torch.cuda.synchronize()
        print(f"phase 14 {feat} detect_stack on the timed stitch's "
              f"{len(grays)} work images {tuple(grays[0].shape)}, "
              f"{cfg.num_features} features: {time.perf_counter() - t0:.4f} "
              f"s; card '{smi}'", flush=True)
        (gray, _), _, got = rec.calls["detect_features"][0]
        cmp = detector_vs_cpu(feat, gray, got, cfg.num_features)
        print(f"phase 14 {feat} detector on the card vs the CPU on view 0 "
              f"({tuple(gray.shape)}): {cmp['valid']} valid on both, "
              f"{cmp['paired']} paired (same octave, 1e-2 px, 1e-3 rad; "
              f"{cmp['same_slot']} at the same slot), {cmp['unpaired']} not "
              f"paired; {cmp['desc_note']}; the CPU detector took "
              f"{cmp['cpu_s']:.3f} s", flush=True)
        if feat == "akaze":
            k4_12 = check_k4_words(dev, feats, "AKAZE")
        elif feat == "sift":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stitcher.detect_features(gray, cfg)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            one = torch.cuda.max_memory_allocated() - base
            print(f"phase 14 sift on one {tuple(gray.shape)} view: peak "
                  f"device memory above its input {one / 2 ** 30:.3f} GiB "
                  f"({one} bytes), {one_s:.4f} s; card '{smi}'", flush=True)
        del run, rec, feats, gray, got, grays
        torch.cuda.empty_cache()
    print("phase 14 " + stage_table(columns), flush=True)
    return dict(by_path=by_path, k4_12=k4_12)


# Phase 15: the JAX package's bench.py gp_sharded (bench.py:734-791) and
# pairs (bench.py:527-558) configurations.
GP_SHARDED = dict(n_images=12, hw=(1024, 1536), focal=1400.0, yaw=0.5,
                  seed=0, shards=4, strength=5.0)
PAIRS = dict(batch=64, hw=(480, 640), n_features=1024, n_hyp=512, seed=0,
             check_batch=8, check_seed=42, roll=(7, 5))
PHASE15_REPS = 3


def gp_sharded_args(dev, blend_type):
    """gp_sharded's compose arguments: noise images (numpy seed 0) on the
    device, focal 1400, spherical, yaws 0.5 i, full seam masks, no
    compensator, blend strength 5."""
    from scipy.spatial.transform import Rotation
    from image_stitching_tpu_torch.ops.warps import make_warper
    gp = GP_SHARDED
    n, (h, w), focal = gp["n_images"], gp["hw"], gp["focal"]
    rng = np.random.default_rng(gp["seed"])
    imgs = torch.as_tensor(rng.uniform(0, 255, (n, h, w, 3)).astype(
        np.float32), device=dev)
    k = np.tile(np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    rs = np.stack([Rotation.from_euler("y", gp["yaw"] * i).as_matrix()
                   .astype(np.float32) for i in range(n)])
    warper = make_warper("spherical", focal)
    rois = [warper.warp_roi((h, w), k[i], rs[i]) for i in range(n)]
    corners = [(r[0], r[1]) for r in rois]
    sizes = [(r[2], r[3]) for r in rois]
    masks = [np.full((s[1], s[0]), 255, np.uint8) for s in sizes]
    return (imgs, k, rs, warper, corners, sizes, masks, corners, 1.0, None,
            blend_type, gp["strength"])


def sharded_vs_fused(dev, mesh, args, exact: bool):
    """fused_compose_sharded against fused_compose on the same inputs, as
    tests/test_parallel.py:74-136 holds them: the same shape, over both
    masks mean |diff| < 0.5 and p99 <= 2, or (FEATHER) no difference."""
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    pano_s, mask_s = cf.fused_compose_sharded(mesh, *args)
    pano_f, mask_f = cf.fused_compose(*args)
    pano_f, mask_f = pano_f.cpu().numpy(), mask_f.cpu().numpy()
    assert pano_s.shape == pano_f.shape and mask_s.shape == mask_f.shape, \
        (pano_s.shape, pano_f.shape)
    both = mask_s & mask_f
    diff = np.abs(pano_s - pano_f)[both]
    out = dict(mean=float(diff.mean()), p99=float(np.percentile(diff, 99)),
               max=float(diff.max()), mask_equal=bool(np.array_equal(
                   mask_s, mask_f)), shape=pano_s.shape)
    if exact:
        assert out["max"] == 0.0, f"sharded FEATHER differs by {out['max']}"
    else:
        assert out["mean"] < 0.5 and out["p99"] <= 2.0, out
    return out


def shard_kernel_check(dev, k2_calls, k5_call):
    """Phase 15a: K2 on one shard's samples (one call per image over the
    shard's frame) and K5 on that shard's one call, each against its plain
    version (phase 3's and 7's gates) with device, call and plain ms and
    the bounds, grid_sample beside K2."""
    from image_stitching_tpu_torch.kernels.multiband import (
        pyramid_accumulate, pyramid_accumulate_plain)
    from image_stitching_tpu_torch.kernels.warp_gather import (
        warp_bilinear, warp_bilinear_plain)
    k2_err = k2_max_diff(k2_calls)

    def run2(fn):
        for src, sx, sy in k2_calls:
            fn(src, sx, sy)
    k2_bound_ms, k2_bound_by = k2_bound(k2_calls)
    n_calls = len(k2_calls)
    k2 = dict(err=k2_err, rects=[tuple(c[1].shape) for c in k2_calls[:1]],
              calls=n_calls,
              device_ms=device_ms(lambda: run2(warp_bilinear), reps=3,
                                  replays=2) / n_calls,
              call_ms=time_ms(lambda: run2(warp_bilinear), reps=3) / n_calls,
              plain_ms=time_ms(lambda: run2(warp_bilinear_plain), reps=1)
              / n_calls,
              library_ms=k2_library_ms(k2_calls)[0], bound_ms=k2_bound_ms,
              bound_by=k2_bound_by)
    warped, weight, offs, accs, nb = k5_call

    def fresh():
        return [torch.zeros(a.shape, device=dev) for a in accs]
    acc_k, acc_p = fresh(), fresh()
    pyramid_accumulate(warped, weight, offs, acc_k, nb)
    pyramid_accumulate_plain(warped, weight, offs, acc_p, nb)
    err, u8 = _k5_gates(acc_k, acc_p, nb, "shard")
    del acc_p
    scratch = acc_k
    launches = kernel_launches(
        lambda: pyramid_accumulate(warped, weight, offs, scratch, nb))
    assert launches <= 2 * nb + 1, f"K5 shard: {launches} launches a call"
    k5_bound_ms, k5_bound_by = k5_chunk_bound(warped, offs, scratch, nb)
    k5 = dict(err=err, u8=u8, n_bands=nb, launches_per_call=launches,
              chunk=tuple(warped.shape), accs=tuple(scratch[0].shape),
              device_ms=device_ms(lambda: pyramid_accumulate(
                  warped, weight, offs, scratch, nb), reps=3, replays=2),
              call_ms=time_ms(lambda: pyramid_accumulate(
                  warped, weight, offs, scratch, nb), reps=3),
              plain_ms=time_ms(lambda: pyramid_accumulate_plain(
                  warped, weight, offs, scratch, nb), reps=1),
              bound_ms=k5_bound_ms, bound_by=k5_bound_by)
    return k2, k5


def run_phase15a(counters, smi, dev):
    """Phase 15a, gp_sharded: fused_compose_sharded on a (1, 4) mesh of
    this card, the shards one after another; its ms per composite
    (download included, fresh content each rep) after a warm-up, canvas
    MP/s and peak device memory; the composite against fused_compose
    (multiband and FEATHER); K2 and K5 at a shard's shapes."""
    from image_stitching_tpu_torch.config import BlenderType
    from image_stitching_tpu_torch.parallel.mesh import make_mesh
    from image_stitching_tpu_torch.pipeline import compose_fused as cf
    gp = GP_SHARDED
    mesh = make_mesh((1, gp["shards"]), ("dp", "sp"),
                     devices=[dev] * gp["shards"])
    args = gp_sharded_args(dev, BlenderType.MULTI_BAND)
    imgs = args[0]
    cf.fused_compose_sharded(mesh, *args)          # warm-up
    rec = Recorder(cf, "warp_bilinear", "pyramid_accumulate")
    for fn in counters:
        fn.launches = 0
    with rec:
        pano, mask = cf.fused_compose_sharded(mesh, *args)
    launches = {fn.__name__: fn.launches for fn in counters}
    assert launches["warp_bilinear"] == gp["shards"] * gp["n_images"], \
        launches
    assert launches["pyramid_accumulate"] >= gp["shards"], launches
    assert np.isfinite(pano).all() and mask.mean() > 0.5, mask.mean()
    k5_calls = rec.calls["pyramid_accumulate"]
    nb = k5_calls[0][0][4]
    frame = tuple(k5_calls[0][0][0].shape[2:])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(PHASE15_REPS):
        pano, mask = cf.fused_compose_sharded(mesh, imgs + float(i + 1),
                                              *args[1:])
    dt = (time.perf_counter() - t0) / PHASE15_REPS
    peak = torch.cuda.max_memory_allocated()
    mp = pano.shape[0] * pano.shape[1] / 1e6
    print(f"phase 15a gp_sharded (bench.py:734-791): {gp['n_images']} x "
          f"{gp['hw'][0]}x{gp['hw'][1]}x3 noise, focal {gp['focal']:g}, "
          f"spherical, MULTI_BAND strength {gp['strength']:g} -> {nb} "
          f"bands; canvas {pano.shape[0]}x{pano.shape[1]} ({mp:.3f} MP) "
          f"on a (1, {gp['shards']}) mesh of {dev} (shards one after "
          f"another, frame {frame} each), launches {launches} for one "
          f"composite; {dt * 1e3:.3f} ms per composite over "
          f"{PHASE15_REPS} reps with fresh content, download included "
          f"({mp / dt:.3f} canvas MP/s), peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; card '{smi}'", flush=True)
    del pano, mask
    mb = sharded_vs_fused(dev, mesh, args, exact=False)
    fe = sharded_vs_fused(dev, mesh, gp_sharded_args(
        dev, BlenderType.FEATHER), exact=True)
    print(f"phase 15a sharded against fused_compose (tests/test_parallel.py"
          f":74-136's bounds): multiband shape {mb['shape']}, masks equal "
          f"{mb['mask_equal']}, |diff| over both masks mean "
          f"{mb['mean']:.4f} (< 0.5), p99 {mb['p99']:.1f} (<= 2), max "
          f"{mb['max']:.1f}; FEATHER masks equal {fe['mask_equal']}, max "
          f"|diff| {fe['max']:.1f} (exact)", flush=True)
    n_img = gp["n_images"]
    k2_calls = [c[0] for c in rec.calls["warp_bilinear"][:n_img]]
    k5_call = k5_calls[0][0]
    del rec, k5_calls
    k2, k5 = shard_kernel_check(dev, k2_calls, k5_call)
    del k2_calls, k5_call
    torch.cuda.empty_cache()
    print(f"phase 15a K2 on shard 0's {k2['calls']} samples of "
          f"{k2['rects'][0]} (sources {gp['hw'][0]}x{gp['hw'][1]}x3): max "
          f"|diff| {k2['err']:.3g} (atol 1e-4), per call: kernel device "
          f"{k2['device_ms']:.4f} ms, call {k2['call_ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, grid_sample device "
          f"{k2['library_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2['bound_by']}, {k2['bound_ms'] / k2['device_ms']:.1%} of it "
          f"reached)", flush=True)
    print(f"phase 15a K5 on shard 0's call {k5['chunk']} ({k5['n_bands']} "
          f"bands, accumulators {k5['accs']}): accumulators "
          f"{k5['err']:.3g} (tol 2e-3), finalized u8 {k5['u8']} (tol 1), "
          f"masks equal, {k5['launches_per_call']} kernel launches; per "
          f"call: kernel device {k5['device_ms']:.4f} ms, call "
          f"{k5['call_ms']:.4f} ms, plain {k5['plain_ms']:.4f} ms, bound "
          f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}, "
          f"{k5['bound_ms'] / k5['device_ms']:.1%} of it reached)",
          flush=True)
    return dict(launches=launches, k2=k2, k5=k5, ms=dt * 1e3, mp=mp,
                peak=peak, n_bands=nb)


def h_close(h_got, h_want, what: str):
    """Batches of H within 1e-4 of each pair's largest entry, the measure
    tests/test_torch_matching.py holds RANSAC's H to: the card's batched
    9x9 eigensolver in the DLT refit rounds unlike the one-matrix solver,
    so a pair's H moves with the batch it is solved in.  Returns (max
    |diff|, max |diff| over the largest entry)."""
    diff = (h_got - h_want).abs().amax(dim=(-2, -1))
    rel = float((diff / h_want.abs().amax(dim=(-2, -1))).max())
    assert rel <= 1e-4, f"{what}: H differs by {rel:.3g} of its largest entry"
    return float(diff.max()), rel


def run_phase15b(counters, smi, dev):
    """Phase 15b, pairs: make_batched_register on a dp mesh of this card,
    64 noise pairs of 480x640 at 1024 features and n_hyp 512, pairs/s
    after a warm-up; 8 pairs of a noise base and its roll by (7, 5): every
    n_inliers > 20, one register_pair call a pair with the same key and
    a dp-2 mesh of this card against dp 1 (n_inliers equal, H by
    `h_close`); K1 and K4 at this shape against their plain versions;
    K6 on the batch's images, every level, bit for bit (`k6_equal`).
    Pair p takes the key split(PRNGKey(seed), batch)[p], as bench.py:537
    makes them."""
    from image_stitching_tpu_torch.core.prng import PRNGKey, split
    from image_stitching_tpu_torch.ops.features.orb import orb_detect_stack
    from image_stitching_tpu_torch.ops.matching import register_pair
    from image_stitching_tpu_torch.parallel.batched import (
        make_batched_register)
    from image_stitching_tpu_torch.parallel.mesh import make_mesh
    pp = PAIRS
    h, w = pp["hw"]
    kw = dict(n_features=pp["n_features"], n_hyp=pp["n_hyp"])
    fn = make_batched_register(make_mesh((1, 1), devices=[dev]), (h, w),
                               **kw)
    rng = np.random.default_rng(pp["seed"])
    pairs = torch.as_tensor(rng.uniform(0, 255, (pp["batch"], 2, h, w))
                            .astype(np.float32), device=dev)
    keys = split(PRNGKey(pp["seed"], dev), pp["batch"])
    fn(pairs, keys)                                # warm-up
    for c in counters:
        c.launches = 0
    fn(pairs, keys)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    assert launches["orb_sample_levels"] == 2 * pp["batch"], launches
    assert launches["hamming_two_nn_pairs"] == 1, launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PHASE15_REPS):
        out = fn(pairs + float(i + 1), keys)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pairs_per_s = PHASE15_REPS * pp["batch"] / dt
    print(f"phase 15b pairs (bench.py:527-558): {pp['batch']} noise pairs "
          f"of {h}x{w}, {pp['n_features']} features, n_hyp {pp['n_hyp']}, "
          f"a dp mesh of [{dev}]: launches {launches} for one batch; "
          f"{dt / (PHASE15_REPS * pp['batch']) * 1e3:.4f} ms a pair over "
          f"{PHASE15_REPS} reps with fresh content ({pairs_per_s:.2f} "
          f"pairs/s); card '{smi}'", flush=True)
    del out
    rng = np.random.default_rng(pp["check_seed"])
    base = rng.uniform(0, 255, (pp["check_batch"], h, w)).astype(np.float32)
    check = torch.as_tensor(np.stack(
        [base, np.roll(base, pp["roll"], (1, 2))], axis=1), device=dev)
    ckeys = split(PRNGKey(pp["seed"], dev), pp["check_batch"])
    hb, cb, nb = fn(check, ckeys)
    n_min = int(nb.min())
    assert n_min > 20, f"rolled pairs: n_inliers {nb.tolist()}"
    single = [register_pair(check[i, 0], check[i, 1], ckeys[i], **kw)
              for i in range(pp["check_batch"])]
    n_single = torch.stack([p.num_inliers for p in single])
    h_single = torch.stack([p.h for p in single])
    assert torch.equal(n_single, nb), (n_single.tolist(), nb.tolist())
    h_err, h_rel = h_close(h_single, hb, "single calls")
    fn2 = make_batched_register(make_mesh((2, 1), devices=[dev, dev]),
                                (h, w), **kw)
    h2, c2, n2 = fn2(check, ckeys)
    assert torch.equal(n2, nb), (n2.tolist(), nb.tolist())
    h2_err, h2_rel = h_close(h2, hb, "dp 2")
    print(f"phase 15b rolled pairs ({pp['check_batch']} pairs, base and its "
          f"roll by {pp['roll']}, seed {pp['check_seed']}): n_inliers "
          f"{nb.tolist()} (min {n_min} > 20), confidence "
          f"{[round(float(c), 4) for c in cb]}; one register_pair a pair "
          f"with the same key: n_inliers equal, H max |diff| "
          f"{h_err:.3g} ({h_rel:.3g} of the pair's largest entry, <= 1e-4);"
          f" a dp-2 mesh of [{dev}, {dev}]: n_inliers equal, H max |diff| "
          f"{h2_err:.3g} ({h2_rel:.3g}, <= 1e-4)", flush=True)
    k1, _ = check_k1(dev, pairs[0, 0], pp["n_features"], "15b",
                     "orb_sample_levels",
                     "image_stitching_tpu/kernels/orb_sample_pallas.py:145")
    feats = orb_detect_stack(pairs.reshape(2 * pp["batch"], h, w),
                             pp["n_features"])
    ii = torch.arange(0, 2 * pp["batch"], 2, dtype=torch.int32, device=dev)
    tm = k4_times((feats.desc.contiguous(), feats.valid.contiguous(), ii,
                   ii + 1), feats.valid)
    print(f"phase 15b K4 hamming_two_nn_pairs on the batch's {pp['batch']} "
          f"pairs of K={pp['n_features']}, both directions, one call: "
          f"equal to its plain version; per call: device "
          f"{tm['dev_ms']:.4f} ms, call {tm['call_ms']:.4f} ms, plain "
          f"{tm['plain_ms']:.4f} ms; bound over {tm['n_dist']:.0f} valid "
          f"distances {tm['bound_ms']:.4f} ms ({tm['route']})", flush=True)
    k6_equal(pairs.reshape(2 * pp["batch"], h, w),
             launches["orb_detect_maps"], "15b")
    return dict(launches=launches, k1=k1, k4=tm, pairs_per_s=pairs_per_s)


def run_phase16(stitch, stitcher, counters, caps_default, k_true, rs_true,
                smi, dev):
    """Phase 16, the slice's path: stitch() with StitchConfig(num_features=
    WIDE_K) on DEFAULT_RING (the JAX CLI's `--num-features 70000`), with
    the kernels' counts set to 0 just before it and read just after: one
    K4 call, on K = 70000 (64-bit keys); its kept views, reprojection error
    and wall printed (the reference's near-duplicate rule may drop views
    at this many matches, so neither is gated); a finite panorama; and its
    K4 call again under the count, against the plain version on three
    slices of rows, with its device ms and bound."""
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.kernels.hamming import (
        hamming_two_nn_pairs, key_bits)
    cfg = StitchConfig(num_features=WIDE_K)
    rec = Recorder(stitcher, "match_all_pairs")
    res, wall, launches = stitch_run(stitch, caps_default, cfg, counters, rec)
    assert launches["hamming_two_nn_pairs"] == 1, launches
    pano = res.panorama
    assert pano.ndim == 3 and bool(torch.isfinite(pano).all()), pano.shape
    feats = rec.calls["match_all_pairs"][0][0][0]
    del rec
    k, words = feats.desc.shape[1], feats.desc.shape[2]
    assert k == WIDE_K and key_bits(k, words) == 64, (k, words)
    kept = res.kept_indices
    err = (reproj_err_px(res.cameras, kept, k_true, rs_true, res.work_scale)
           if len(kept) > 1 else float("nan"))
    args = k4_args(dev, feats)
    got, k4_launches = _one_launch(args)
    assert k4_launches == 1, k4_launches
    rows = torch.cat([torch.arange(0, 256), torch.arange(32768, 33024),
                      torch.arange(k - 256, k)]).to(dev)
    _k4_equal(tuple(tuple(x[:, rows] for x in side) for side in got),
              k4_plain_rows(args, rows), f"the K = {k} stitch's call")
    del got
    tm = dict(dev_ms=device_ms(lambda: hamming_two_nn_pairs(*args), reps=2,
                               replays=2))
    tm.update(k4_bound(args, feats.valid))
    stages = ", ".join(f"{name}={v:.4f}s"
                       for name, v in res.stage_times.items())
    print(f"phase 16 the slice's path, StitchConfig(num_features={WIDE_K}) "
          f"on DEFAULT_RING: kept {len(kept)}/{N_IMAGES} {kept}, "
          f"reprojection {err:.4f} px, panorama {tuple(pano.shape)}, valid "
          f"features {feats.valid.sum(-1).tolist()}, launches {launches} "
          f"(K4 once, {key_bits(k, words)}-bit keys), wall {wall:.4f} s "
          f"(the first stitch at this K), stages: {stages}; its K4 call "
          f"({len(args[2])} pairs of K={k}, both directions) equal to the "
          f"plain version on rows 0-255, 32768-33023 and the last 256, "
          f"device {tm['dev_ms']:.4f} ms, bound over {tm['n_dist']:.0f} "
          f"valid distances {tm['bound_ms']:.4f} ms "
          f"({tm['tensor_ms'] / tm['dev_ms']:.1%} of the tensor-core "
          f"bound); card '{smi}'", flush=True)
    return dict(launches=launches, dev_ms=tm["dev_ms"],
                bound_ms=tm["bound_ms"], pairs=len(args[2]), wall=wall,
                kept=len(kept), err=err)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.core import image_io, native
    from image_stitching_tpu_torch.kernels import _build
    from image_stitching_tpu_torch.kernels.hamming import hamming_two_nn_pairs
    from image_stitching_tpu_torch.kernels.multiband import pyramid_accumulate
    from image_stitching_tpu_torch.kernels.orb_detect import orb_detect_maps
    from image_stitching_tpu_torch.kernels.orb_sample import orb_sample_levels
    from image_stitching_tpu_torch.kernels.ransac_score import (
        ransac_score_counts)
    from image_stitching_tpu_torch.kernels.warp_gather import warp_bilinear
    from image_stitching_tpu_torch.ops import ransac as ransac_mod
    from image_stitching_tpu_torch.ops.imgproc import (resize, rgb_to_gray,
                                                      scale_size)
    from image_stitching_tpu_torch.pipeline import stitcher
    from image_stitching_tpu_torch.pipeline.stitcher import stitch

    dev = torch.device("cuda")
    smi = _smi()
    print(f"phase 0 env: torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, nvidia-smi '{smi}', host CPUs "
          f"{os.cpu_count()}, native runtime: tracked library "
          f"{'present' if os.path.exists(native._TRACKED) else 'absent'}, "
          f"a build here links {list(native.codec_libs())}", flush=True)
    counters = (orb_sample_levels, warp_bilinear, hamming_two_nn_pairs,
                pyramid_accumulate, orb_detect_maps)
    names = [fn.__name__ for fn in counters]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        caps = os.path.join(work, "caps")
        caps_default = os.path.join(work, "caps_default")
        caps_plain = os.path.join(work, "caps_plain")
        caps_noisy = os.path.join(work, "caps_noisy")
        t0 = time.perf_counter()
        workers = max(1, min(8, os.cpu_count() or 1))
        k_true, rs_true = write_e2e_rings(caps, caps_default, caps_plain,
                                          workers, caps_noisy)
        print(f"phase 0 captures: 2 rings of {N_IMAGES} x {H}x{W} (noise "
              f"sigma 4 and {DEFAULT_RING['noise_sigma']}, the second also "
              f"written without EXIF; the same views at sigma "
              f"{DETECTOR_RING_SIGMA:g} for phase 14) rendered and written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        t0 = time.perf_counter()
        bench_caps = render_bench_dirs(work, workers)
        print(f"phase 0 captures: bench.py's cyl4 sets (4 x 1080x1920, 55 "
              f"deg, 0.45 overlap, seeds {CYL4_SEEDS}) and vga_pair sets "
              f"(2 x 480x640, 55 deg, 0.5 overlap, seeds {VGA_SEEDS}) "
              f"rendered and written in {time.perf_counter() - t0:.3f} s",
              flush=True)
        t0 = time.perf_counter()
        caps11, truth11 = render_phase11_dirs(work, workers)
        print(f"phase 0 captures: bench.py's rig37 (37 x {RIG_HW[0]}x"
              f"{RIG_HW[1]}, seed {RIG_SEED}), its +-2 LSB twin, its copy "
              f"with frames {INFILL_FRAMES} made noise, and the affine scan "
              f"(2x2 tiles of {TILE_HW[0]}x{TILE_HW[1]}, no EXIF) rendered "
              f"and written in {time.perf_counter() - t0:.3f} s", flush=True)
        t0 = time.perf_counter()
        caps12, truth12 = render_phase12_dirs(work, workers)
        print(f"phase 0 captures: mixed8 ({len(MIXED_HWS)} views of "
              f"{sorted(set(MIXED_HWS))} alternating, DEFAULT_RING's "
              f"geometry and noise) and bench.py's spher16 "
              f"({SPHER16['n_images']} x {SPHER16['hw'][0]}x"
              f"{SPHER16['hw'][1]}, seed {SPHER16['seed']}, sigma-8 noise) "
              f"with its +-2 LSB twin rendered and written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        t0 = time.perf_counter()
        caps13, truth13 = render_phase13_dirs(work, workers)
        print(f"phase 0 captures: bench.py's mosaic100 ("
              f"{MOSAIC100['n_images']} x {MOSAIC100['hw'][0]}x"
              f"{MOSAIC100['hw'][1]}, fov {MOSAIC100['fov_deg']} deg, seed "
              f"{MOSAIC100['seed']}, detailed texture) with its +-2 LSB twin "
              f"rendered and written in {time.perf_counter() - t0:.3f} s",
              flush=True)

        # The kernels (nvcc) and the host runtime (g++) build side by side.
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            runtime = pool.submit(native.load)
            _build.load_library()
            runtime.result()
        rt = native.runtime_info()
        assert rt["origin"] in ("tracked", "built") and rt["links"], rt
        print(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
              f"{_build.build_seconds():.3f} s; native runtime "
              f"{rt['origin']} ({rt['path']}, {rt['seconds']:.3f} s, links "
              f"{rt['links']}); host codec {image_io.codec_name()}",
              flush=True)
        run_phase1b(dev, smi)

        paths = image_io.list_images(caps)
        img0 = torch.from_numpy(image_io.orient_capture(
            image_io.imread(paths[0]), False)).to(dev)
        k1, _ = check_k1(
            dev, rgb_to_gray(resize(img0, (H // 2, W // 2))), 1500, "2",
            "orb_sample_levels",
            "image_stitching_tpu/kernels/orb_sample_pallas.py:145")

        # The work-scale path: half-resolution ORB, no exposure, no seams.
        cfg = StitchConfig(num_features=1500, work_megapix=1.9,
                           expos_comp_type="no", seam_find_type="no",
                           fast_ingest=False, checkpoint_dir=work)
        # The warm-up stitch also gives phase 3 its cameras.
        warm = stitch(caps, cfg, output="", device="cuda")
        k2 = check_k2(dev, paths, cfg, warm)
        k2["cylindrical_device_ms"] = check_k2_more(dev, stitch, bench_caps,
                                                    work)
        res, wall, launches = stitch_run(stitch, caps, cfg, counters)
        err, coverage, stages = e2e_gates(res, k_true, rs_true, launches,
                                          names)
        print(f"phase 4 e2e work-scale path: kept {len(res.kept_indices)}/"
              f"{N_IMAGES}, reprojection {err:.4f} px, panorama "
              f"{tuple(res.panorama.shape)}, mask {coverage:.4f}, launches "
              f"{launches}, wall {wall:.4f} s "
              f"({N_IMAGES * H * W / 1e6 / wall:.3f} MP/s), stages: "
              f"{stages}; card '{smi}'", flush=True)
        by_path = {"phase 4": launches}
        del warm, res

        # K3: K1 on every level of the default path's first capture; its
        # row is the full-resolution level 0 launched alone.
        img0 = torch.from_numpy(image_io.orient_capture(image_io.imread(
            image_io.list_images(caps_default)[0]), False)).to(dev)
        k1_default, k3 = check_k1(
            dev, rgb_to_gray(img0.to(torch.float32)), 4000, "5",
            "orb_sample_levels",
            "image_stitching_tpu/kernels/orb_stream_pallas.py:143")
        k3["name"] = f"orb_sample_levels [K3: level 0 at {H}x{W}]"
        k3["default_launch_device_ms"] = k1_default["device_ms"]

        # The default path: the reference defaults but fast ingest.
        cfg = StitchConfig(fast_ingest=False, checkpoint_dir=work)
        rec = Recorder(stitcher, "match_all_pairs", "fused_compose")
        with rec:
            warm = stitch(caps_default, cfg, output="", device="cuda")
        k4 = check_k4(dev, rec.calls["match_all_pairs"][0][0][0])
        k4_chunked = check_k4_chunked(
            dev, rec.calls["match_all_pairs"][0][0][0], cfg)
        k4_wide = check_k4_wide(dev)
        k5 = check_k5(dev, rec.calls["fused_compose"][0])
        del warm, rec
        rec = Recorder(stitcher, "match_all_pairs", "find_seams",
                       "fused_compose", "detect_stack")
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
        assert launches["orb_sample_levels"] <= N_IMAGES, launches
        assert launches["hamming_two_nn_pairs"] <= 2, launches
        assert launches["pyramid_accumulate"] <= k5["buckets"], launches
        by_path["phase 8"] = launches
        legacy_stages = res.stage_times
        k6_equal(rec.calls["detect_stack"][0][0][0],
                 launches["orb_detect_maps"], "8")
        print(f"phase 8 per default stitch, by the counters and phases 5 and "
              f"6: K1 {launches['orb_sample_levels']} launches x "
              f"{k1_default['device_ms']:.4f} ms = "
              f"{launches['orb_sample_levels'] * k1_default['device_ms']:.4f}"
              f" ms device, K4 {launches['hamming_two_nn_pairs']} x "
              f"{k4['device_ms']:.4f} ms = "
              f"{launches['hamming_two_nn_pairs'] * k4['device_ms']:.4f} ms "
              f"device", flush=True)
        del res, rec

        # Fast ingest with the reference default configuration.
        seam_hw = scale_size(H, W, min(1.0, (0.1e6 / (H * W)) ** 0.5))
        check_ingest(dev, image_io.list_images(caps_default), seam_hw)
        torch.cuda.empty_cache()
        cwd = os.getcwd()
        os.chdir(work)      # StitchConfig()'s checkpoints go to "."
        try:
            cfg = StitchConfig()
            assert cfg.fast_ingest and cfg.work_megapix < 0
            stitch(caps_default, cfg, output="", device="cuda")
            rec = Recorder(stitcher, "find_seams", "fused_compose",
                           "fast_prep", "bundle_adjust", "match_all_pairs")
            ransac_score_counts.launches = 0
            with Recorder(ransac_mod, "ransac_score_counts") as rec7:
                res, wall, launches = stitch_run(stitch, caps_default, cfg,
                                                 counters, rec)
            k7_9b = ransac_score_counts.launches
            versus_jax = ring_reference_check(
                res, rec.calls["match_all_pairs"][0][2], caps_default)
            # Phase 10d resumes from this stitch's checkpoint.
            ck9b = os.path.join(work, "checkpoint_9b")
            os.makedirs(ck9b)
            for name in ("cams.data", "indices.data"):
                shutil.copy(name, ck9b)
            base_9b, wall_9b = res, wall
            ba_9b = rec.calls["bundle_adjust"][0][2]
            corners_9b = rec.calls["fused_compose"][0][0][4]
            err, coverage, stages = e2e_gates(res, k_true, rs_true, launches,
                                              names)
            fi = rec.calls["fast_prep"][0][0][0]
            assert fi.raw_yuv and fi.raw_num8 == 8, "not the raw route"
            comp = rec.calls["fused_compose"][0][0][9]
            for i, (gh, gw) in enumerate(comp.grid_sizes):
                gains = comp.gains[i, :gh, :gw]
                assert np.all(np.isfinite(gains)) and np.all(gains > 0), \
                    f"image {i}: gains not finite and positive"
            covered, cut = seam_union_gate(rec.calls["find_seams"][0])
            assert launches["orb_sample_levels"] <= N_IMAGES, launches
            assert launches["hamming_two_nn_pairs"] <= 2, launches
            assert launches["pyramid_accumulate"] <= k5["buckets"], launches
            by_path["phase 9b"] = launches
            pano_hw = tuple(res.panorama.shape[:2])
            print(f"phase 9b e2e StitchConfig() (fast ingest, raw num8 "
                  f"{fi.raw_num8}): kept {len(res.kept_indices)}/{N_IMAGES}, "
                  f"reprojection {err:.4f} px, panorama "
                  f"{tuple(res.panorama.shape)}, mask {coverage:.4f}, seam "
                  f"union = warped union ({covered} px, {cut} px cut), "
                  f"launches {launches}, wall {wall:.4f} s "
                  f"({N_IMAGES * H * W / 1e6 / wall:.3f} MP/s), stages: "
                  f"{stages}; {versus_jax}; card '{smi}'\n" + stage_table(
                      [("phase 8 legacy decode", legacy_stages),
                       ("phase 9b fast ingest", res.stage_times)]),
                  flush=True)
            k6 = check_k6(dev, rec.calls["fast_prep"][0][2][0],
                          launches["orb_detect_maps"])
            k7 = check_k7(rec7.calls["ransac_score_counts"], "9b", k7_9b)
            del rec7
            del rec, comp

            cfg = StitchConfig(num_features=1500, work_megapix=1.9)
            stitch(caps, cfg, output="", device="cuda")
            rec = Recorder(stitcher, "fast_prep")
            res, wall, launches = stitch_run(stitch, caps, cfg, counters, rec)
            err, coverage, stages = e2e_gates(res, k_true, rs_true, launches,
                                              names)
            fi = rec.calls["fast_prep"][0][0][0]
            assert fi.raw_yuv and fi.raw_num8 == 4, (fi.raw_yuv, fi.raw_num8)
            by_path["phase 9c"] = launches
            print(f"phase 9c e2e bench configuration (num_features=1500, "
                  f"work_megapix=1.9; raw route num8 {fi.raw_num8}, work "
                  f"scale {res.work_scale}): kept {len(res.kept_indices)}/"
                  f"{N_IMAGES}, reprojection {err:.4f} px, panorama "
                  f"{tuple(res.panorama.shape)}, mask {coverage:.4f}, "
                  f"launches {launches}, wall {wall:.4f} s "
                  f"({N_IMAGES * H * W / 1e6 / wall:.3f} MP/s), stages: "
                  f"{stages}; card '{smi}'", flush=True)
            del res, rec

            out_jpg = os.path.join(work, "cli_result.jpg")
            env = dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__)))
            t0 = time.perf_counter()
            cli = subprocess.run(
                [sys.executable, "-m", "image_stitching_tpu_torch",
                 caps_default, "--result", out_jpg, "--checkpoint-dir",
                 work], env=env, capture_output=True, text=True, timeout=600)
            cli_s = time.perf_counter() - t0
            assert cli.returncode == 0, \
                f"CLI exit {cli.returncode}: {cli.stderr[-2000:]}"
            from PIL import Image
            with Image.open(out_jpg) as im:
                assert im.size == (pano_hw[1], pano_hw[0]), \
                    (im.size, pano_hw)
            print(f"phase 9d python -m image_stitching_tpu_torch: exit 0 in "
                  f"{cli_s:.3f} s (a new process: start, kernel load, one "
                  f"cold stitch), wrote a {pano_hw[1]}x{pano_hw[0]} JPEG, "
                  f"the size of phase 9b's panorama; its lines: "
                  + "; ".join(cli.stdout.strip().splitlines()), flush=True)
            phase10 = run_phase10(stitch, stitcher, counters, names,
                                  bench_caps, caps_default, k_true, rs_true,
                                  base_9b, wall_9b, ba_9b, corners_9b, ck9b,
                                  work, smi, dev)
            by_path.update(phase10["by_path"])
            k5["zero_band_device_ms"] = phase10["k5_zero_band"]["device_ms"]
            k5["zero_band_launches_per_call"] = \
                phase10["k5_zero_band"]["launches_per_call"]
            k5["zero_band_bound_ms"] = phase10["k5_zero_band"]["bound_ms"]
            phase11 = run_phase11(stitch, stitcher, counters, names, caps11,
                                  truth11, caps_default, caps_plain, k_true,
                                  rs_true, smi, dev)
            by_path.update(phase11["by_path"])
            k4.update(rig37_pairs=phase11["k4"]["pairs"],
                      rig37_device_ms=phase11["k4"]["dev_ms"],
                      rig37_call_ms=phase11["k4"]["call_ms"],
                      rig37_plain_ms=phase11["k4"]["plain_ms"],
                      rig37_bound_ms=phase11["k4"]["bound_ms"])
            k7.update({f"rig37_{key}": phase11["k7"][key] for key in (
                "pairs", "calls", "device_ms", "call_ms", "plain_ms",
                "bound_ms", "equal_share", "max_abs_err")})
            k7["launches_by_path"] = {"phase 9b": k7_9b,
                                      "phase 11b": phase11["k7"]["calls"]}
            k5.update(rig37_buckets=phase11["k5"]["buckets"],
                      rig37_device_ms_per_call=phase11["k5"]["device_ms"],
                      rig37_bound_ms_per_call=phase11["k5"]["bound_ms"])
            k2.update(affine_device_ms=phase11["k2"]["device_ms"],
                      affine_bound_ms=phase11["k2"]["bound_ms"])
            phase12 = run_phase12(stitch, counters, names, caps12, truth12,
                                  caps_default, k_true, rs_true, base_9b,
                                  work, smi)
            by_path.update(phase12["by_path"])
            loop2, loop5 = phase12["k2"], phase12["k5"]
            k2.update(loop_device_ms=loop2["device_ms"],
                      loop_call_ms=loop2["call_ms"],
                      loop_plain_ms=loop2["plain_ms"],
                      loop_bound_ms=loop2["bound_ms"],
                      loop_library_ms=loop2["library_ms"],
                      loop_max_abs_err=loop2["err"])
            k5.update(loop_device_ms_per_call=loop5["device_ms"],
                      loop_call_ms=loop5["call_ms"],
                      loop_plain_ms=loop5["plain_ms"],
                      loop_bound_ms_per_call=loop5["bound_ms"],
                      loop_launches_per_call=loop5["launches_per_call"],
                      loop_max_abs_err=loop5["err"])
            phase13 = run_phase13(stitch, counters, names, caps13, truth13,
                                  caps_default, base_9b, work, smi, dev)
            by_path.update(phase13["by_path"])
            m4, s2, s5 = phase13["k4"], phase13["k2"], phase13["k5"]
            m1, m2, m5 = (phase13["mosaic100"][k] for k in ("k1", "k2", "k5"))
            k1.update(mosaic100_device_ms=m1["device_ms"],
                      mosaic100_call_ms=m1["call_ms"],
                      mosaic100_plain_ms=m1["plain_ms"],
                      mosaic100_bound_ms=m1["bound_ms"],
                      mosaic100_max_abs_err=m1["max_abs_err"])
            k2.update(mosaic100_device_ms=m2["device_ms"],
                      mosaic100_call_ms=m2["call_ms"],
                      mosaic100_plain_ms=m2["plain_ms"],
                      mosaic100_bound_ms=m2["bound_ms"],
                      mosaic100_library_ms=m2["library_ms"],
                      mosaic100_max_abs_err=m2["err"])
            k5.update(mosaic100_buckets=m5["buckets"],
                      mosaic100_device_ms_per_call=m5["device_ms"],
                      mosaic100_call_ms=m5["call_ms"],
                      mosaic100_plain_ms=m5["plain_ms"],
                      mosaic100_bound_ms_per_call=m5["bound_ms"],
                      mosaic100_max_abs_err=m5["err"])
            k4.update(mosaic100_pairs=m4["pairs"],
                      mosaic100_device_ms=m4["dev_ms"],
                      mosaic100_call_ms=m4["call_ms"],
                      mosaic100_plain_ms=m4["plain_ms"],
                      mosaic100_bound_ms=m4["bound_ms"])
            k2.update(strip_rects=s2["rects"],
                      strip_device_ms=s2["device_ms"],
                      strip_call_ms=s2["call_ms"],
                      strip_plain_ms=s2["plain_ms"],
                      strip_bound_ms=s2["bound_ms"],
                      strip_library_ms=s2["library_ms"],
                      strip_max_abs_err=s2["err"])
            phase14 = run_phase14(stitch, stitcher, counters, caps_default,
                                  caps_noisy, k_true, rs_true, base_9b, smi,
                                  dev)
            by_path.update(phase14["by_path"])
            k4_12 = phase14["k4_12"]
            k5.update(strip_call_shape=list(s5["chunk"]),
                      strip_n_bands=s5["n_bands"],
                      strip_device_ms_per_call=s5["device_ms"],
                      strip_call_ms=s5["call_ms"],
                      strip_plain_ms=s5["plain_ms"],
                      strip_bound_ms_per_call=s5["bound_ms"],
                      strip_launches_per_call=s5["launches_per_call"],
                      strip_max_abs_err=s5["err"])
            g15 = run_phase15a(counters, smi, dev)
            by_path["phase 15a"] = g15["launches"]
            p15 = run_phase15b(counters, smi, dev)
            by_path["phase 15b"] = p15["launches"]
            p16 = run_phase16(stitch, stitcher, counters, caps_default,
                              k_true, rs_true, smi, dev)
            by_path["phase 16"] = p16["launches"]
            s2, s5, b1, b4 = g15["k2"], g15["k5"], p15["k1"], p15["k4"]
            k2.update(shard_frame=list(s2["rects"][0]),
                      shard_device_ms=s2["device_ms"],
                      shard_call_ms=s2["call_ms"],
                      shard_plain_ms=s2["plain_ms"],
                      shard_bound_ms=s2["bound_ms"],
                      shard_library_ms=s2["library_ms"],
                      shard_max_abs_err=s2["err"])
            k5.update(shard_call_shape=list(s5["chunk"]),
                      shard_n_bands=s5["n_bands"],
                      shard_device_ms_per_call=s5["device_ms"],
                      shard_call_ms=s5["call_ms"],
                      shard_plain_ms=s5["plain_ms"],
                      shard_bound_ms_per_call=s5["bound_ms"],
                      shard_launches_per_call=s5["launches_per_call"],
                      shard_max_abs_err=s5["err"])
            k1.update(pairs_device_ms=b1["device_ms"],
                      pairs_call_ms=b1["call_ms"],
                      pairs_plain_ms=b1["plain_ms"],
                      pairs_bound_ms=b1["bound_ms"],
                      pairs_max_abs_err=b1["max_abs_err"])
            k4.update(pairs_pairs=PAIRS["batch"],
                      pairs_device_ms=b4["dev_ms"],
                      pairs_call_ms=b4["call_ms"],
                      pairs_plain_ms=b4["plain_ms"],
                      pairs_bound_ms=b4["bound_ms"])
        finally:
            os.chdir(cwd)

    main_path = by_path["phase 9b"]
    for row, fn in ((k1, orb_sample_levels), (k2, warp_bilinear),
                    (k3, orb_sample_levels), (k4, hamming_two_nn_pairs),
                    (k5, pyramid_accumulate), (k6, orb_detect_maps)):
        row["launches"] = main_path[fn.__name__]
        row["launches_by_path"] = {path: counts[fn.__name__]
                                   for path, counts in by_path.items()}
    # K4 at 12 words: its path is phase 14's AKAZE stitch.
    k4_12["launches"] = by_path["phase 14 akaze"]["hamming_two_nn_pairs"]
    k4_12["launches_by_path"] = {
        path: counts["hamming_two_nn_pairs"]
        for path, counts in by_path.items() if path.startswith("phase 14")}
    # K = 70000: its path is phase 16's stitch.
    k4_wide[0]["launches"] = by_path["phase 16"]["hamming_two_nn_pairs"]
    k4_wide[0]["launches_by_path"]["phase 16"] = k4_wide[0]["launches"]
    k4_wide[0].update(stitch_pairs=p16["pairs"],
                      stitch_device_ms=p16["dev_ms"],
                      stitch_bound_ms=p16["bound_ms"])

    print(f"smoke total {time.perf_counter() - t_start:.1f} s; phase 15: "
          f"gp_sharded {g15['ms']:.3f} ms a composite "
          f"({g15['mp'] / g15['ms'] * 1e3:.3f} canvas MP/s, {g15['n_bands']} "
          f"bands, peak {g15['peak'] / 2 ** 30:.3f} GiB), pairs "
          f"{p15['pairs_per_s']:.2f} pairs/s; card '{smi}'", flush=True)
    k7["launches"] = k7["launches_by_path"]["phase 9b"]
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k4_12] + k4_chunked +
                      k4_wide + [k6, k7]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
