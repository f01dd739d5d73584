"""stitch() on the card in the configurations no benchmark cell runs, each
case held to its own gates (marked `cuda`).

The benchmark's cells time and judge the reference's default stitch of
the 8 MP ring and of the 37-view rig.  These cases run the rest of the
port's surface on the card: the JAX package's bench.py configurations
(cyl4, vga_pair, rig37 at 960x1280, mosaic100, spher16, gigapixel's
strips, gp_sharded, pairs), every seam finder, the resume, the
registration variants, the loop compose, the strips through stitch(),
the other detectors, 70000 features, the CLI in a process of its own, and
the 8 x 2448x3264 ring under `StitchConfig()` held to the JAX package's
stitch of the same files on the CPU (`tests/data/ring_reference_jax.json`,
`tools/ring_reference_jax.py`).  The gates are the configuration's: the
views kept, the mean pairwise reprojection error against the ground truth
(px), the mask's coverage, the seam masks' union against the warped
masks', finite positive exposure gains, and the hand kernels launched;
where the stitch hands a kernel its real inputs, the kernel is held there
to its plain version (K2 within 1e-4; K4 indices and distances equal; K5
accumulators within 2e-3, the finalized u8 within 1, masks equal, at most
2 n_bands + 1 kernels a call; K6 bit for bit; K7 counts as
`tests/test_torch_ransac_score.py` holds them).

Each case renders its captures after `cuda_device()`, so without a card
it skips before rendering anything; the module renders each capture set
once.  Cases whose render or stitch takes more than ~30 s on the card are
also marked `slow`.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from _torch_port import (Recorder, assert_h_close, check_k2, check_k4,
                         check_k5, check_k6, check_k7, cuda_device,
                         rel_rotation_deg)
from image_stitching_tpu_torch.config import (BlenderType,
                                              ExposureCompensatorType,
                                              StitchConfig)
from image_stitching_tpu_torch.core import exif, image_io, native, persistence
from image_stitching_tpu_torch.core.prng import PRNGKey, split
from image_stitching_tpu_torch.core.rig import DEFAULT_RIG
from image_stitching_tpu_torch.data import synth
from image_stitching_tpu_torch.estimation.pose_infill import find_nearest_kept
from image_stitching_tpu_torch.kernels import (hamming, multiband, orb_detect,
                                               orb_sample, ransac_score,
                                               warp_gather)
from image_stitching_tpu_torch.ops import blend, crop, pyr_mat, ransac, warps
from image_stitching_tpu_torch.ops.exposure import feed_device
from image_stitching_tpu_torch.ops.features import (
    akaze, sift_detect_and_describe, surf_detect_and_describe)
from image_stitching_tpu_torch.ops.features.orb import orb_detect_stack
from image_stitching_tpu_torch.ops.imgproc import resize, scale_size
from image_stitching_tpu_torch.ops.matching import register_pair
from image_stitching_tpu_torch.ops.seams import find_seams
from image_stitching_tpu_torch.parallel.batched import make_batched_register
from image_stitching_tpu_torch.parallel.mesh import make_mesh
from image_stitching_tpu_torch.pipeline import compose_fused as cf
from image_stitching_tpu_torch.pipeline import stitcher

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = torch.device("cuda")
RING = dict(n_images=8, hw=(2448, 3264), fov_deg=55.0, overlap_ratio=0.5,
            seed=7)               # data/synth.py's E2E_RING and DEFAULT_RING
RING_SIGMAS = dict(e2e=4.0, default=8.0, noisy=12.0)
CYL4 = dict(n_images=4, hw=(1080, 1920), fov_deg=55.0, overlap_ratio=0.45,
            seed=11)              # bench.py:250-264
VGA = dict(n_images=2, hw=(480, 640), fov_deg=55.0, overlap_ratio=0.5,
           seed=101)              # bench.py:198-212
RIG = dict(hw=(960, 1280), seed=21, infill=(5, 15, 30))  # bench.py:322-375
TILE_HW, TILE_STEP = (1080, 1920), (648, 1152)
MIXED_HWS = [(2448, 3264), (3000, 4000)] * 4
SPHER16 = dict(n_images=16, hw=(3000, 4000), fov_deg=55.0,
               overlap_ratio=0.45, seed=41)     # bench.py:445-519
MOSAIC100 = dict(n_images=100, hw=(480, 640), fov_deg=8.0,
                 overlap_ratio=0.55, seed=31)   # bench.py:378-442
GIGAPIXEL = dict(rows=12, cols=24, hw=(1024, 1536), focal=6000.0,
                 overlap=0.25, strip_w=4096, chunk=48)  # bench.py:561-731
GP_SHARDED = dict(n_images=12, hw=(1024, 1536), focal=1400.0, yaw=0.5,
                  shards=4, strength=5.0)      # bench.py:734-791
PAIRS = dict(batch=64, hw=(480, 640), n_features=1024, n_hyp=512,
             check_batch=8, roll=(7, 5))        # bench.py:527-558
# The CLI's match_conf rule; on DEFAULT_RING the near-duplicate rule
# zeroes SIFT's and two of SURF's adjacent pairs (ROADMAP fault (q)), so
# those detectors are held on the sigma-12 ring (SIFT at 1500 features).
DETECTOR_MATCH_CONF = {"sift": 0.65, "surf": 0.65, "akaze": 0.32}
DETECTOR_KEEP = {"sift": dict(num_features=1500), "surf": {}, "akaze": {}}
ALL = ("K1", "K2", "K4", "K5", "K6")
# Beside the strip compose's terms in its memory gate: the allocator's
# rounding and the small tensors (rect grids, offsets, events).
MEM_SLACK = 128 * 2 ** 20


# ---- captures ------------------------------------------------------------

def _pool():
    import multiprocessing as mp
    return mp.get_context("spawn").Pool(max(1, min(8, os.cpu_count() or 1)))


def _truth(k, rs):
    return dict(k=np.asarray(k, np.float64),
                rs=[np.asarray(r, np.float64) for r in rs])


def render_rings(root):
    """The 8 x 2448x3264 ring as `write_ring_dir` writes it, each view
    rendered once and given its noise at sigma 4 (`e2e`), 8 (`default`,
    also without EXIF as `plain`) and 12 (`noisy`)."""
    assert {k: v for k, v in synth.DEFAULT_RING.items()
            if k != "noise_sigma"} == synth.E2E_RING
    k, rs = synth.ring_geometry(RING["n_images"], RING["hw"],
                                RING["fov_deg"], RING["overlap_ratio"])
    with _pool() as pool:
        views = pool.map(synth._render_args,
                         [(k, r, RING["hw"], RING["seed"]) for r in rs])
    rs32 = np.stack([r.astype(np.float32) for r in rs])
    out = _truth(k, rs32)
    for name, sigma in RING_SIGMAS.items():
        images = [synth.ring_view_noise(v, i, sigma)
                  for i, v in enumerate(views)]
        out[name] = os.path.join(root, name)
        synth.write_capture_dir(out[name], images, k.astype(np.float32),
                                rs32)
        if name == "default":
            out["plain"] = os.path.join(root, "plain")
            synth.write_capture_dir(out["plain"], images,
                                    k.astype(np.float32), rs32,
                                    with_exif=False)
    return out


def _ring_set(geo, detail=False):
    def render(root):
        with _pool() as pool:
            images, k, rs = synth.make_ring_captures(
                texture_detail=detail, pool=pool, **geo)
        synth.write_capture_dir(root, images, k, rs)
        return dict(_truth(k, rs), dir=root)
    return render


def render_rig(root):
    """bench.py's rig37 at 960x1280 (seed 21), and a copy with frames 5,
    15 and 30 made noise."""
    with _pool() as pool:
        images, k, rs = synth.make_rig_captures(
            hw=RIG["hw"], seed=RIG["seed"], pool=pool)
    out = dict(_truth(k, rs), rig37=os.path.join(root, "rig37"),
               infill=os.path.join(root, "infill"))
    synth.write_capture_dir(out["rig37"], images, k, rs)
    rng = np.random.default_rng(5)
    synth.write_capture_dir(out["infill"], [
        rng.uniform(0, 255, im.shape).astype(np.float32)
        if i in RIG["infill"] else im for i, im in enumerate(images)], k, rs)
    return out


def render_affine(root):
    """A 2x2 mosaic of 1080x1920 tiles without EXIF, 40% overlap, cut from
    one planar texture (coordinates / 1600 as the sphere texture's lon,
    lat), each under a similarity (rotation <= 3 deg, scale 0.97-1.03),
    sigma-8 noise; the truth is each tile's similarity to tile 0."""
    rng = np.random.default_rng(31)
    h, w = TILE_HW
    pc = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    mid = pc + np.array([TILE_STEP[1], TILE_STEP[0]]) / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ts, jobs = [], []
    for row in range(2):
        for col in range(2):
            th = np.radians(rng.uniform(-3.0, 3.0))
            lin = rng.uniform(0.97, 1.03) * np.array(
                [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            t = np.eye(3)
            t[:2, :2] = lin
            t[:2, 2] = pc + np.array([col * TILE_STEP[1],
                                      row * TILE_STEP[0]]) - lin @ pc
            gx = t[0, 0] * xs + t[0, 1] * ys + t[0, 2]
            gy = t[1, 0] * xs + t[1, 1] * ys + t[1, 2]
            jobs.append((((gx - mid[0]) / 1600.0).astype(np.float32),
                         ((gy - mid[1]) / 1600.0).astype(np.float32)))
            ts.append(t)
    with _pool() as pool:
        views = pool.starmap(synth.sphere_texture_rgb, jobs)
    images = [np.clip(v + np.random.default_rng(2000 + i).normal(
        0.0, 8.0, v.shape).astype(np.float32), 0.0, 255.0)
        for i, v in enumerate(views)]
    synth.write_capture_dir(root, images, np.eye(3, dtype=np.float32),
                            np.stack([np.eye(3, dtype=np.float32)] * 4),
                            with_exif=False)
    return dict(dir=root, tiles=[np.linalg.inv(ts[0]) @ t for t in ts])


def render_mixed(root):
    """DEFAULT_RING's geometry with views 1, 3, 5, 7 at 3000x4000, each at
    its own K (one 55-degree field) and EXIF payload, sigma-8 noise."""
    geo = [synth.ring_geometry(len(MIXED_HWS), hw, 55.0, 0.5)
           for hw in MIXED_HWS]
    with _pool() as pool:
        images = pool.map(synth._render_noisy, [
            (i, geo[i][0], geo[i][1][i], hw, 7, 8.0)
            for i, hw in enumerate(MIXED_HWS)])
    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(images):
        k, r = geo[i][0].astype(np.float32), geo[i][1][i].astype(np.float32)
        image_io.write_jpeg_with_description(
            os.path.join(root, f"{i}.jpg"),
            image_io.rotate_180(np.clip(img, 0, 255).astype(np.uint8)),
            exif.camera_to_image_description(
                focal=float(k[1, 1]), ppx=float(k[0, 2]), ppy=float(k[1, 2]),
                R=r, is_portrait=False), quality=92)
    return dict(dir=root, k=[g[0] for g in geo],
                rs=[g[1][i] for i, g in enumerate(geo)])


def render_spher16(root):
    g = SPHER16
    k, rs = synth.ring_geometry(g["n_images"], g["hw"], g["fov_deg"],
                                g["overlap_ratio"])
    with _pool() as pool:
        images, k32, rs32 = synth._noisy_views(k, rs, g["hw"], g["seed"],
                                               8.0, pool)
    synth.write_capture_dir(root, images, k32, rs32)
    return dict(_truth(k32, rs32), dir=root)


RENDER = {"rings": render_rings, "cyl4": _ring_set(CYL4),
          "vga": _ring_set(VGA), "rig": render_rig, "affine": render_affine,
          "mixed8": render_mixed, "spher16": render_spher16,
          "mosaic100": _ring_set(MOSAIC100, detail=True)}


class Captures:
    """The module's capture sets, each rendered on first use."""

    def __init__(self, root):
        self.root, self.sets = root, {}

    def __getitem__(self, name):
        if name not in self.sets:
            self.sets[name] = RENDER[name](os.path.join(self.root, name))
        return self.sets[name]


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    cuda_device()
    return Captures(str(tmp_path_factory.mktemp("card_e2e")))


# ---- counting and gates --------------------------------------------------

def _kernels():
    return dict(K1=orb_sample.orb_sample_levels,
                K2=warp_gather.warp_bilinear,
                K4=hamming.hamming_two_nn_pairs,
                K5=multiband.pyramid_accumulate,
                K6=orb_detect.orb_detect_maps,
                K7=ransac_score.ransac_score_counts)


@contextlib.contextmanager
def counted():
    """Yields a dict that holds, on exit (a raise included), each kernel's
    launches inside."""
    before = {k: fn.launches for k, fn in _kernels().items()}
    out = {}
    try:
        yield out
    finally:
        out.update({k: fn.launches - before[k]
                    for k, fn in _kernels().items()})


def stitch_counted(directory, cfg, names=(), output=""):
    """stitch() on the card, its kernels counted and the stitcher's
    `names` recorded: (result, launches, recorder)."""
    rec = Recorder(stitcher, *names)
    with rec, counted() as launches:
        res = stitcher.stitch(directory, cfg, output=output, device=DEV)
    return res, launches, rec


def reproj_err_px(res, truth, hw, pairs=None):
    """Mean pairwise reprojection error (px) of the kept views of size hw
    (or one (h, w) a view), over `pairs` of positions in the kept list
    (default consecutive ones): K_b R_b R_a^T K_a^-1 against the truth on
    an 8x8 grid of view a (bench.py `_reproj_err_px`)."""
    kept, n_all = res.kept_indices, len(truth["rs"])
    ks = truth["k"] if isinstance(truth["k"], list) else [truth["k"]] * n_all
    hws = hw if isinstance(hw, list) else [hw] * n_all
    c = res.cameras.numpy()
    kc = np.zeros((len(kept), 3, 3))
    kc[:, 0, 0], kc[:, 0, 2] = c["focal"], c["ppx"]
    kc[:, 1, 1], kc[:, 1, 2] = c["focal"] * c["aspect"], c["ppy"]
    kc[:, 2, 2] = 1.0
    kc[:, :2, :] /= res.work_scale
    rc = np.asarray(c["R"], np.float64)

    def proj(m, hw_a):
        gy, gx = np.meshgrid(np.linspace(0, hw_a[0] - 1, 8),
                             np.linspace(0, hw_a[1] - 1, 8))
        q = m @ np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])
        return q[:2] / np.where(np.abs(q[2:]) < 1e-12, 1e-12, q[2:])
    errs = []
    for a, b in pairs or [(a, a + 1) for a in range(len(kept) - 1)]:
        ia, ib = kept[a], kept[b]
        h_est = kc[b] @ rc[b].T @ rc[a] @ np.linalg.inv(kc[a])
        h_gt = (ks[ib] @ truth["rs"][ib].T @ truth["rs"][ia]
                @ np.linalg.inv(ks[ia]))
        errs.append(np.linalg.norm(proj(h_est, hws[ia]) -
                                   proj(h_gt, hws[ia]), axis=0).mean())
    return float(np.mean(errs))


def check_stitch(res, launches, truth, hw, names=ALL, pairs=None,
                 coverage=0.9, reproj=True):
    """Every view kept, a finite (H, W, 3) panorama, the reprojection
    error <= 1 px, the mask's coverage above `coverage`, `names` launched."""
    pano = res.panorama
    assert pano.ndim == 3 and pano.shape[2] == 3, tuple(pano.shape)
    assert bool(torch.isfinite(pano).all()), "non-finite panorama"
    assert res.kept_indices == list(range(len(truth["rs"]))), \
        res.kept_indices
    if reproj:
        err = reproj_err_px(res, truth, hw, pairs)
        assert err <= 1.0, f"reprojection error {err:.4f} px"
    if coverage:
        assert float(res.mask.float().mean()) > coverage
    for name in names:
        assert launches[name] > 0, (name, launches)


def check_seam_union(call):
    """The seam masks' union equals the warped masks', pixel for pixel,
    on the seam-scale canvas with u folded modulo the ring's period."""
    args, kwargs, seam_masks = call
    corners, period = args[0], kwargs.get("period")

    def union(masks):
        keys = []
        for (x0, y0), m in zip(corners, masks):
            ys, xs = np.nonzero(np.asarray(m) > 0)
            xs = np.mod(xs + x0, period) if period else xs + x0
            keys.append((ys.astype(np.int64) + y0) * (1 << 32) + xs)
        return np.unique(np.concatenate(keys))
    assert np.array_equal(union(args[1]), union(seam_masks))


def check_gains(comp):
    """Every view's exposure gains finite and positive."""
    for i, (gh, gw) in enumerate(comp.grid_sizes):
        gains = comp.gains[i, :gh, :gw]
        assert np.all(np.isfinite(gains)) and np.all(gains > 0), i


def k4_args(feats, range_width=-1):
    """K4's arguments as match_all_pairs makes them: every pair i < j
    (within range_width when > 0), both directions in one call."""
    n = feats.desc.shape[0]
    iu, ju = np.triu_indices(n, 1)
    if range_width > 0:
        keep = (ju - iu) < range_width
        iu, ju = iu[keep], ju[keep]
    dev = feats.desc.device
    return (feats.desc.contiguous(), feats.valid.contiguous(),
            torch.as_tensor(iu, dtype=torch.int32, device=dev),
            torch.as_tensor(ju, dtype=torch.int32, device=dev))


def check_k6_views(grays, path_launches):
    """K6 (`check_k6`) on each (H, W) view of `grays` at every level ORB
    keeps; the stitch made one launch a level and view."""
    h, w = grays[0].shape
    levels = [(lv,) + scale_size(h, w, 1.0 / 1.2 ** lv) for lv in range(8)]
    levels = [lv for lv in levels if min(lv[1:]) >= 48]
    for gray in grays:
        for lv in levels:
            check_k6(gray, *lv)
    assert path_launches == len(grays) * len(levels), path_launches


def check_buckets(launches, compose_call):
    """The stitch's K1, K4 and K5 launches: at most one K1 a view, at most
    two K4, no more K5 calls than the compose has buckets."""
    args = compose_call[0]
    g = cf.compose_rects(args[4], args[5], args[10], args[11])
    assert launches["K1"] <= len(args[1]) and launches["K4"] <= 2, launches
    assert launches["K5"] <= len(g.buckets), (launches, len(g.buckets))


def check_banded_up(frame_hw, nb):
    """The collapse's pyrUp on the card at every level of a (h, w) frame
    whose output has an axis above the dense threshold: the banded
    `pyr_up_mm` against the dense matrices on a random band, within rtol
    1e-5 and atol 1e-4."""
    h, w = frame_hw
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    checked = 0
    for b in range(nb, 0, -1):
        in_hw, out_hw = (h >> b, w >> b), (h >> (b - 1), w >> (b - 1))
        if max(out_hw) <= pyr_mat._T_DENSE:
            continue
        x = torch.rand((3,) + in_hw, generator=gen, device=DEV) * 255.0
        uh, uw = (torch.as_tensor(pyr_mat._up_mat_np.__wrapped__(o, i),
                                  device=DEV)
                  for o, i in zip(out_hw, in_hw))
        want = uh @ x @ uw.t()
        excess = float(((pyr_mat.pyr_up_mm(x, out_hw) - want).abs() -
                        1e-5 * want.abs()).max())
        assert excess <= 1e-4, (in_hw, out_hw, excess)
        checked += 1
        del uh, uw, x, want
    torch.cuda.empty_cache()
    assert checked > 0


def _cfg(**kw):
    """A StitchConfig whose checkpoint directory exists."""
    if "checkpoint_dir" in kw:
        os.makedirs(kw["checkpoint_dir"], exist_ok=True)
    return StitchConfig(**kw)


# ---- the 8 x 2448x3264 ring ---------------------------------------------

def case_work_scale(caps, tmp):
    """The JAX bench's work-scale path, on the legacy decode: 1500
    features at 1.9 MP, no exposure compensation, the "no" seam finder;
    K2 on its compose rects."""
    r = caps["rings"]
    with Recorder(cf, "warp_bilinear") as k2:
        res, launches, _ = stitch_counted(r["e2e"], _cfg(
            num_features=1500, work_megapix=1.9, expos_comp_type="no",
            seam_find_type="no", fast_ingest=False, checkpoint_dir=tmp))
    check_stitch(res, launches, r, RING["hw"])
    check_k2(k2.calls["warp_bilinear"])


def case_legacy_default(caps, tmp):
    """The reference defaults on the legacy decode; K2, K4, K5 and K6 on
    what the stitch handed them."""
    r = caps["rings"]
    with Recorder(cf, "warp_bilinear", "pyramid_accumulate") as kr:
        res, launches, rec = stitch_counted(
            r["default"], _cfg(fast_ingest=False, checkpoint_dir=tmp),
            ("match_all_pairs", "find_seams", "fused_compose",
             "detect_stack"))
    check_stitch(res, launches, r, RING["hw"])
    check_gains(rec.calls["fused_compose"][0][0][9])
    check_seam_union(rec.calls["find_seams"][0])
    check_buckets(launches, rec.calls["fused_compose"][0])
    check_k6_views(rec.calls["detect_stack"][0][0][0], launches["K6"])
    feats = rec.calls["match_all_pairs"][0][0][0]
    assert torch.equal(hamming.unpack_pm1(feats.desc.contiguous()),
                       hamming.pm1_rows(feats.desc.contiguous()))
    check_k4(k4_args(feats))
    check_k2(kr.calls["warp_bilinear"])
    check_k5(kr.calls["pyramid_accumulate"])


def check_ring_reference(res, caps_dir):
    """Against the JAX package's stitch of the same files on the CPU:
    the same files, kept indices equal, focal within rtol 1e-3, adjacent
    relative rotations within 0.05 degrees."""
    with open(os.path.join(ROOT, "tests", "data",
                           "ring_reference_jax.json")) as f:
        ref = json.load(f)
    for name, digest in ref["capture_sha256"].items():
        with open(os.path.join(caps_dir, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digest, name
    assert res.kept_indices == ref["kept_indices"]
    cams = res.cameras.numpy()
    focal_ref = np.asarray(ref["focal"])
    assert np.max(np.abs(cams["focal"] - focal_ref) / focal_ref) <= 1e-3
    r_ref = np.asarray(ref["R"])
    assert max(rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                                r_ref[a + 1] @ r_ref[a].T)
               for a in range(len(r_ref) - 1)) <= 0.05


def case_default(caps, tmp):
    """Exactly StitchConfig() (fast ingest on the raw 4:2:0 route at num8
    8), held to the JAX package's stitch of the same files; K6 on its u8
    work grays, K7 on its RANSAC calls; the native runtime it loaded."""
    r = caps["rings"]
    cfg = _cfg()
    assert cfg.fast_ingest and cfg.work_megapix < 0
    with Recorder(ransac, "ransac_score_counts") as k7:
        res, launches, rec = stitch_counted(
            r["default"], cfg, ("find_seams", "fused_compose", "fast_prep"))
    check_ring_reference(res, r["default"])
    check_stitch(res, launches, r, RING["hw"])
    fi = rec.calls["fast_prep"][0][0][0]
    assert fi.raw_yuv and fi.raw_num8 == 8
    check_gains(rec.calls["fused_compose"][0][0][9])
    check_seam_union(rec.calls["find_seams"][0])
    check_buckets(launches, rec.calls["fused_compose"][0])
    check_k6_views(rec.calls["fast_prep"][0][2][0], launches["K6"])
    check_k7(k7.calls["ransac_score_counts"])
    rt = native.runtime_info()
    assert rt["origin"] in ("tracked", "built") and rt["links"], rt


def case_bench_config(caps, tmp):
    """The JAX package's bench configuration on fast ingest: the raw
    route at num8 4."""
    r = caps["rings"]
    res, launches, rec = stitch_counted(r["e2e"], _cfg(
        num_features=1500, work_megapix=1.9, checkpoint_dir=tmp),
        ("fast_prep",))
    check_stitch(res, launches, r, RING["hw"])
    fi = rec.calls["fast_prep"][0][0][0]
    assert fi.raw_yuv and fi.raw_num8 == 4, (fi.raw_yuv, fi.raw_num8)


def case_cli(caps, tmp):
    """`python -m image_stitching_tpu_torch` in a process of its own:
    exit 0 and a JPEG the size of StitchConfig()'s panorama."""
    r = caps["rings"]
    out = os.path.join(tmp, "cli_result.jpg")
    cli = subprocess.run(
        [sys.executable, "-m", "image_stitching_tpu_torch", r["default"],
         "--result", out, "--checkpoint-dir", tmp],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    assert cli.returncode == 0, cli.stderr[-2000:]
    res, _, _ = stitch_counted(r["default"], _cfg(
        checkpoint_dir=os.path.join(tmp, "in_process")))
    with Image.open(out) as im:
        assert im.size == (res.panorama.shape[1], res.panorama.shape[0])


def case_seams(finder):
    def case(caps, tmp):
        r = caps["rings"]
        res, launches, rec = stitch_counted(r["default"], _cfg(
            seam_find_type=finder, checkpoint_dir=tmp), ("find_seams",))
        check_stitch(res, launches, r, RING["hw"])
        check_seam_union(rec.calls["find_seams"][0])
    case.__doc__ = f"StitchConfig(seam_find_type={finder!r})."
    return case


def check_resumed(res, base, ba_cams, ck_dir, corners, base_corners,
                  mean_tol):
    """A stitch resumed from `base`'s checkpoint: kept indices equal; the
    checkpoint's cameras base's bundle adjustment within the text format's
    6 digits; focals equal after it; canvases within 2 px of each other;
    on their common canvas the masks equal off a 1-pixel band of base's
    mask edge and (unless mean_tol is None) the panorama within mean
    |diff| mean_tol."""
    assert res.kept_indices == base.kept_indices
    assert persistence.deserialize_indices(ck_dir) == base.kept_indices
    saved = persistence.deserialize_camera_params(ck_dir, DEV).numpy()
    want = ba_cams.numpy()
    for name in ("focal", "aspect", "ppx", "ppy", "R", "t"):
        np.testing.assert_allclose(saved[name].astype(np.float64),
                                   want[name].astype(np.float64),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
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
    ma, mb = crop(res.mask, oa), crop(base.mask, ob)
    if mean_tol is not None:
        diff = (crop(res.panorama, oa) - crop(base.panorama, ob)).abs()
        assert float(diff[ma & mb].mean()) <= mean_tol
    mf = mb[None, None].float()
    band = (torch.nn.functional.max_pool2d(mf, 3, 1, 1)[0, 0] > 0) & ~(
        -torch.nn.functional.max_pool2d(-mf, 3, 1, 1)[0, 0] > 0)
    assert not bool(((ma ^ mb) & ~band).any())


def case_resume(caps, tmp):
    """StitchConfig(serialize_data=False) from StitchConfig()'s checkpoint,
    on fast ingest (which decodes at the compose's DCT scale, so only the
    geometry is held) and on the legacy decode (panorama within mean
    |diff| 0.5 of the registered stitch's)."""
    r = caps["rings"]
    ck = os.path.join(tmp, "checkpoint")
    base, _, rec = stitch_counted(r["default"], _cfg(checkpoint_dir=ck),
                                  ("bundle_adjust", "fused_compose"))
    ba, corners = (rec.calls["bundle_adjust"][0][2],
                   rec.calls["fused_compose"][0][0][4])
    for extra, tol in (({}, None), (dict(fast_ingest=False), 0.5)):
        cfg = _cfg(serialize_data=False, checkpoint_dir=ck, **extra)
        res, launches, rec = stitch_counted(
            r["default"], cfg, ("fused_compose", "start_fast_ingest"))
        check_resumed(res, base, ba, ck, rec.calls["fused_compose"][0][0][4],
                      corners, tol)
        assert launches["K2"] > 0 and launches["K5"] > 0, launches
        assert [kw["want_gray"] for _, kw, _ in
                rec.calls["start_fast_ingest"]] == (
            [False] if cfg.fast_ingest else [])


def case_no_exif(caps, tmp):
    """StitchConfig() on the ring written without EXIF (the seed from
    homography_based_estimate; its reprojection is not gated: the
    reference's autocalib is erratic on a pure-yaw ring and the default
    refine mask keeps its focal), then use_sensor_priors=False on the EXIF
    files: the same kept views, cameras within 1e-4 (relative)."""
    r = caps["rings"]
    res, launches, rec = stitch_counted(
        r["plain"], _cfg(checkpoint_dir=tmp), ("find_seams", "fused_compose"))
    check_stitch(res, launches, r, RING["hw"], reproj=False)
    check_seam_union(rec.calls["find_seams"][0])
    check_gains(rec.calls["fused_compose"][0][0][9])
    res_p, launches_p, _ = stitch_counted(r["default"], _cfg(
        use_sensor_priors=False, checkpoint_dir=os.path.join(tmp, "p")))
    assert res_p.kept_indices == res.kept_indices
    a, b = res_p.cameras.numpy(), res.cameras.numpy()
    for name in ("focal", "aspect", "ppx", "ppy", "R", "t"):
        x, y = a[name].astype(np.float64), b[name].astype(np.float64)
        assert np.abs(x - y).max() <= 1e-4 * max(np.abs(y).max(), 1e-12)
    assert all(launches_p[name] > 0 for name in ALL), launches_p


def case_ray(caps, tmp):
    """StitchConfig(ba_cost_func="ray")."""
    r = caps["rings"]
    res, launches, rec = stitch_counted(r["default"], _cfg(
        ba_cost_func="ray", checkpoint_dir=tmp),
        ("find_seams", "fused_compose"))
    check_stitch(res, launches, r, RING["hw"])
    check_seam_union(rec.calls["find_seams"][0])
    check_gains(rec.calls["fused_compose"][0][0][9])


def case_timelapse(caps, tmp):
    """StitchConfig(timelapse=True, timelapse_type="as_is") in a working
    directory of its own: frames fixed_0..7.jpg of the union canvas's
    size and no result.jpg (the loop compose; no K5)."""
    r = caps["rings"]
    res, launches, rec = stitch_counted(r["default"], _cfg(
        timelapse=True, timelapse_type="as_is"), ("_loop_compose",),
        output=None)
    comp = rec.calls["_loop_compose"][0][0][1]
    _, _, cw, ch = warps.result_roi(comp.corners, comp.sizes)
    names = [f"fixed_{i}.jpg" for i in range(RING["n_images"])]
    assert sorted(f for f in os.listdir(tmp)
                  if f.startswith("fixed_")) == sorted(names)
    assert res.timelapse_frames == names
    assert not os.path.exists(os.path.join(tmp, "result.jpg"))
    for f in names:
        with Image.open(os.path.join(tmp, f)) as im:
            assert im.size == (cw, ch), (f, im.size)
    check_stitch(res, launches, r, RING["hw"], coverage=None,
                 names=("K1", "K2", "K4", "K6"))
    assert launches["K2"] >= RING["n_images"], launches


def case_strips(caps, tmp):
    """StitchConfig() with compose_strips_mp below its canvas (a quarter
    of its width a strip): the strip compose alone, >= 3 strips, a host
    panorama whose mask equals the whole-canvas stitch's and whose |diff|
    over it has mean < 0.5 and p99 <= 2."""
    r = caps["rings"]
    base, _, _ = stitch_counted(r["default"], _cfg(checkpoint_dir=tmp))
    ch, cw = tuple(base.mask.shape)
    res, launches, rec = stitch_counted(r["default"], _cfg(
        compose_strips_mp=round(ch * cw / 2e6, 3), compose_strip_w=cw // 4,
        checkpoint_dir=os.path.join(tmp, "strips")),
        ("fused_compose", "fused_compose_strips"))
    assert rec.calls["fused_compose"] == []
    (args, kwargs, _), = rec.calls["fused_compose_strips"]
    assert len(cf.strip_rects(args[4], args[5], args[10], args[11],
                              kwargs["strip_w"])[2]) >= 3
    assert res.panorama.device.type == "cpu"
    assert torch.equal(res.mask, base.mask.cpu())
    diff = (res.panorama - base.panorama.cpu()).abs()[res.mask].numpy()
    assert diff.mean() < 0.5 and np.percentile(diff, 99) <= 2.0
    assert all(launches[name] > 0 for name in ALL), launches


def case_features_70000(caps, tmp):
    """StitchConfig(num_features=70000) (the JAX CLI's --num-features
    70000): one K4 call, on 64-bit keys, held to its plain version on
    three slices of rows; its views and reprojection are not gated (the
    near-duplicate rule may drop views at this many matches)."""
    r = caps["rings"]
    res, launches, rec = stitch_counted(r["default"], _cfg(
        num_features=70000, checkpoint_dir=tmp), ("match_all_pairs",))
    assert launches["K4"] == 1, launches
    assert res.panorama.ndim == 3
    assert bool(torch.isfinite(res.panorama).all())
    feats = rec.calls["match_all_pairs"][0][0][0]
    k, words = feats.desc.shape[1:]
    assert k == 70000 and hamming.key_bits(k, words) == 64
    dev = feats.desc.device
    check_k4(k4_args(feats), torch.cat([
        torch.arange(0, 256), torch.arange(32768, 33024),
        torch.arange(k - 256, k)]).to(dev))


# ---- bench.py's other configurations ------------------------------------

def case_cyl4(caps, tmp):
    """bench.py's cyl4: StitchConfig(num_features=1500,
    warp_type="cylindrical"); K2 on its cylindrical compose maps."""
    c = caps["cyl4"]
    with Recorder(cf, "warp_bilinear") as k2:
        res, launches, rec = stitch_counted(c["dir"], _cfg(
            num_features=1500, warp_type="cylindrical", checkpoint_dir=tmp),
            ("find_seams",))
    check_stitch(res, launches, c, CYL4["hw"])
    check_seam_union(rec.calls["find_seams"][0])
    check_k2(k2.calls["warp_bilinear"])


def case_vga_pair(caps, tmp):
    """bench.py's vga_pair: StitchConfig(num_features=1500,
    blend_type="feather"); every K5 call at 0 bands, held to its plain
    version."""
    v = caps["vga"]
    with Recorder(cf, "pyramid_accumulate") as k5:
        res, launches, rec = stitch_counted(v["dir"], _cfg(
            num_features=1500, blend_type="feather", checkpoint_dir=tmp),
            ("find_seams",))
    check_stitch(res, launches, v, VGA["hw"])
    check_seam_union(rec.calls["find_seams"][0])
    calls = k5.calls["pyramid_accumulate"]
    assert calls and all(c[0][4] == 0 for c in calls)
    check_k5(calls)


def case_profile_graph(caps, tmp):
    """vga_pair with profile_dir and save_graph_to: a non-empty trace and
    a DOT file with an edge for every kept adjacent pair."""
    prof, dot = os.path.join(tmp, "profile"), os.path.join(tmp, "g.dot")
    res, _, _ = stitch_counted(caps["vga"]["dir"], _cfg(
        num_features=1500, blend_type="feather", profile_dir=prof,
        save_graph=True, save_graph_to=dot, checkpoint_dir=tmp))
    assert os.path.getsize(os.path.join(prof, "stitch_trace.json")) > 0
    with open(dot) as f:
        text = f.read()
    assert all(f'"{a}.jpg" -- "{a + 1}.jpg"' in text
               for a in res.kept_indices[:-1]), text


def overlapping_pairs(kept, rs_true, max_angle_deg):
    """Positions (a, b) in `kept` whose true optical axes are within
    max_angle_deg (bench.py `_overlapping_pairs`)."""
    z = np.stack([rs_true[i][:, 2] for i in kept])
    ang = np.degrees(np.arccos(np.clip(z @ z.T, -1.0, 1.0)))
    return [(a, b) for a in range(len(kept)) for b in range(a + 1, len(kept))
            if ang[a, b] <= max_angle_deg]


def folded_coverage(mask, compose_call):
    """The share of one u period of the canvas the mask covers, columns
    folded modulo the period (the rig's views cross the date line)."""
    warper = compose_call[0][3]
    period = warps.u_period(warper.proj_name, warper.scale)
    cols = torch.arange(mask.shape[1], device=mask.device) % period
    folded = torch.zeros((mask.shape[0], period),
                         device=mask.device).index_add_(1, cols, mask.float())
    return float((folded > 0).float().mean())


def case_rig37(caps, tmp):
    """bench.py's rig37, StitchConfig(num_features=1000) on 37 x 960x1280:
    <= 1 px over the pairs within 45 degrees, > 0.9 of one 2 pi period
    covered (the rig sees the whole sphere); K4 on its 666 pairs, K5 on
    every bucket, K7 on its RANSAC blocks."""
    g = caps["rig"]
    with Recorder(ransac, "ransac_score_counts") as k7, \
            Recorder(cf, "pyramid_accumulate") as k5:
        res, launches, rec = stitch_counted(g["rig37"], _cfg(
            num_features=1000, checkpoint_dir=tmp),
            ("match_all_pairs", "find_seams", "fused_compose"))
    check_stitch(res, launches, g, RIG["hw"], coverage=None,
                 pairs=overlapping_pairs(res.kept_indices, g["rs"], 45.0))
    assert folded_coverage(res.mask, rec.calls["fused_compose"][0]) > 0.9
    check_seam_union(rec.calls["find_seams"][0])
    check_gains(rec.calls["fused_compose"][0][0][9])
    check_k4(k4_args(rec.calls["match_all_pairs"][0][0][0]))
    check_k5(k5.calls["pyramid_accumulate"])
    check_k7(k7.calls["ransac_score_counts"])


def case_infill(caps, tmp):
    """StitchConfig(num_features=1000, infill_dropped=True) on rig37 with
    frames 5, 15 and 30 made noise: the component drops them, 37 cameras
    come back, each infilled one within 1 degree of the truth relative to
    the neighbour it was made from."""
    g = caps["rig"]
    res, launches, rec = stitch_counted(g["infill"], _cfg(
        num_features=1000, infill_dropped=True, checkpoint_dir=tmp),
        ("biggest_component",))
    kept, removed = rec.calls["biggest_component"][0][2]
    n = DEFAULT_RIG.total_images
    assert set(RIG["infill"]) <= set(removed), removed
    assert len(res.cameras) == n and res.kept_indices == list(range(n))
    r_est = res.cameras.numpy()["R"]
    for j in RIG["infill"]:
        nb = find_nearest_kept(set(kept), j, n, DEFAULT_RIG)
        assert rel_rotation_deg(r_est[nb].T @ r_est[j],
                                g["rs"][nb].T @ g["rs"][j]) <= 1.0, j
    assert all(launches[name] > 0 for name in ALL), launches


def case_affine(caps, tmp):
    """The affine scan mode (matcher, estimator, BA and warp "affine", no
    wave correction) on the 2x2 mosaic without EXIF: each tile's
    similarity within 0.5 degrees and 1% scale of the truth relative to
    tile 0, the mask over 0.9 of the warped tiles' union; K2 on its
    rects."""
    a = caps["affine"]
    cfg = _cfg(matcher_type="affine", estimator_type="affine",
               ba_cost_func="affine", warp_type="affine",
               do_wave_correct=False, checkpoint_dir=tmp)
    with Recorder(cf, "warp_bilinear") as k2:
        res, launches, rec = stitch_counted(a["dir"], cfg,
                                            ("find_seams", "fused_compose"))
    assert res.kept_indices == [0, 1, 2, 3], res.kept_indices
    for got, want in zip(res.cameras.numpy()["R"].astype(np.float64),
                         a["tiles"]):
        ang = np.degrees(np.arctan2(got[1, 0], got[0, 0]) -
                         np.arctan2(want[1, 0], want[0, 0]))
        scale = np.hypot(got[0, 0], got[1, 0]) / np.hypot(want[0, 0],
                                                          want[1, 0]) - 1
        assert abs(ang) <= 0.5 and abs(scale) <= 0.01, (ang, scale)
    images, ks, rs, warper, corners, sizes = rec.calls["fused_compose"][0][
        0][:6]
    cx, cy, cw, ch = cf.compose_rects(corners, sizes, cfg.blend_type,
                                      cfg.blend_strength).canvas
    dev = res.mask.device
    us = cx + torch.arange(cw, dtype=torch.float32, device=dev)
    vs = cy + torch.arange(ch, dtype=torch.float32, device=dev)
    union = torch.zeros((ch, cw), dtype=torch.bool, device=dev)
    for k, r in zip(ks, rs):
        sx, sy, valid = warps.camera_backward_xy(
            warper.proj_name, us, vs, torch.as_tensor(k, device=dev),
            torch.as_tensor(r, device=dev), warper.scale)
        union |= valid & (sx >= 0) & (sx <= images.shape[2] - 1) & (
            sy >= 0) & (sy <= images.shape[1] - 1)
    assert tuple(res.mask.shape) == (ch, cw)
    assert float((res.mask & union).sum()) > 0.9 * float(union.sum())
    check_seam_union(rec.calls["find_seams"][0])
    assert all(launches[name] > 0 for name in ALL), launches
    check_k2(k2.calls["warp_bilinear"])


def case_mixed8(caps, tmp):
    """StitchConfig() on views of two sizes: fast ingest declines the set,
    ORB a view at a time, the host exposure feed, the loop compose (a K2
    a view at each scale, a K5 bucket of one a view), each held to its
    plain version."""
    m = caps["mixed8"]
    n = len(MIXED_HWS)
    with Recorder(warps, "warp_bilinear") as k2, \
            Recorder(blend, "pyramid_accumulate") as k5:
        res, launches, rec = stitch_counted(m["dir"], _cfg(
            checkpoint_dir=tmp), ("start_fast_ingest", "feed", "find_seams"))
    assert rec.calls["start_fast_ingest"][0][2] is None
    check_stitch(res, launches, m, list(MIXED_HWS))
    check_gains(rec.calls["feed"][0][2])
    check_seam_union(rec.calls["find_seams"][0])
    k2_calls, k5_calls = (k2.calls["warp_bilinear"],
                          k5.calls["pyramid_accumulate"])
    assert len(k2_calls) == 2 * n and len(k5_calls) == n
    check_k2(k2_calls[n:])
    check_k5(k5_calls)
    for (_, weight, offs, accs, nb), _, _ in k5_calls:
        assert len(multiband.band_offsets(offs[0], accs,
                                          *weight.shape[1:])) == nb + 1


def case_spher16(caps, tmp):
    """bench.py's spher16, StitchConfig(crop_result=True) on 16 x
    3000x4000: the cropped panorama smaller than the canvas, its gray > 0
    mask with a clean border (check_interior_exterior)."""
    s = caps["spher16"]
    res, launches, _ = stitch_counted(s["dir"], _cfg(
        crop_result=True, checkpoint_dir=tmp))
    check_stitch(res, launches, s, SPHER16["hw"], coverage=None)
    pano = res.panorama
    assert pano.shape[0] * pano.shape[1] < res.mask.numel()
    img8 = np.clip(pano.cpu().numpy(), 0, 255).astype(np.uint8)
    gray = 0.299 * img8[..., 0] + 0.587 * img8[..., 1] + 0.114 * img8[..., 2]
    assert crop.check_interior_exterior(
        np.where(gray > 0, np.uint8(255), np.uint8(0)),
        (0, 0, img8.shape[1], img8.shape[0]))[0]


def case_mosaic100(caps, tmp):
    """bench.py's mosaic100, StitchConfig(range_width=3) on 100 x 480x640
    at 8 degrees (BA's CG solver past 64 cameras): K4 on its 197 pairs, K2
    and K5 on its compose, the banded pyrUp of its collapse."""
    m = caps["mosaic100"]
    with Recorder(cf, "warp_bilinear", "pyramid_accumulate") as kr:
        res, launches, rec = stitch_counted(m["dir"], _cfg(
            range_width=3, checkpoint_dir=tmp),
            ("match_all_pairs", "fused_compose"))
    check_stitch(res, launches, m, MOSAIC100["hw"], coverage=None)
    check_k4(k4_args(rec.calls["match_all_pairs"][0][0][0], 3))
    check_k2(kr.calls["warp_bilinear"])
    check_k5(kr.calls["pyramid_accumulate"])
    args = rec.calls["fused_compose"][0][0]
    g = cf.compose_rects(args[4], args[5], args[10], args[11])
    del kr, rec
    check_banded_up((g.canvas_h, g.canvas_w), g.n_bands)


# ---- outside stitch() ---------------------------------------------------

def gp_sharded_args(blend_type):
    """gp_sharded's compose arguments: noise images (numpy seed 0), focal
    1400, spherical, yaws 0.5 i, full seam masks, no compensator."""
    gp = GP_SHARDED
    n, (h, w), focal = gp["n_images"], gp["hw"], gp["focal"]
    imgs = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 255, (n, h, w, 3)).astype(np.float32), device=DEV)
    k = np.tile(np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    rs = np.stack([Rotation.from_euler("y", gp["yaw"] * i).as_matrix()
                   .astype(np.float32) for i in range(n)])
    warper = warps.make_warper("spherical", focal)
    rois = [warper.warp_roi((h, w), k[i], rs[i]) for i in range(n)]
    corners, sizes = [r[:2] for r in rois], [r[2:] for r in rois]
    masks = [np.full((s[1], s[0]), 255, np.uint8) for s in sizes]
    return (imgs, k, rs, warper, corners, sizes, masks, corners, 1.0, None,
            blend_type, gp["strength"])


def case_gp_sharded(caps, tmp):
    """bench.py's gp_sharded through fused_compose_sharded on a (1, 4)
    mesh of the card: a K2 an image and shard, a K5 call a shard at
    least; against fused_compose (multiband: mean |diff| < 0.5 and p99 <=
    2 over both masks; FEATHER exact); K2 and K5 on shard 0's calls."""
    gp = GP_SHARDED
    mesh = make_mesh((1, gp["shards"]), ("dp", "sp"),
                     devices=[DEV] * gp["shards"])
    for blend_type in (BlenderType.MULTI_BAND, BlenderType.FEATHER):
        args = gp_sharded_args(blend_type)
        with Recorder(cf, "warp_bilinear", "pyramid_accumulate") as kr, \
                counted() as launches:
            pano_s, mask_s = cf.fused_compose_sharded(mesh, *args)
        pano_f, mask_f = (x.cpu().numpy() for x in cf.fused_compose(*args))
        assert pano_s.shape == pano_f.shape and mask_s.shape == mask_f.shape
        diff = np.abs(pano_s - pano_f)[mask_s & mask_f]
        if blend_type == BlenderType.FEATHER:
            assert diff.max() == 0.0
            continue
        assert np.isfinite(pano_s).all() and mask_s.mean() > 0.5
        assert diff.mean() < 0.5 and np.percentile(diff, 99) <= 2.0
        assert launches["K2"] == gp["shards"] * gp["n_images"], launches
        assert launches["K5"] >= gp["shards"], launches
        check_k2(kr.calls["warp_bilinear"][:gp["n_images"]])
        check_k5(kr.calls["pyramid_accumulate"][:1])


def case_pairs(caps, tmp):
    """bench.py's pairs: make_batched_register on a dp mesh of the card,
    64 noise pairs of 480x640 (two K1 a pair, one K4 a batch, K6 on every
    image bit for bit); 8 pairs of a noise base and its roll by (7, 5):
    n_inliers > 20, equal to one register_pair a pair with the same key
    and to a dp-2 mesh of the card, H by `assert_h_close`; K4 on the
    batch's pairs."""
    pp, dev = PAIRS, DEV
    h, w = pp["hw"]
    kw = dict(n_features=pp["n_features"], n_hyp=pp["n_hyp"])
    fn = make_batched_register(make_mesh((1, 1), devices=[dev]), (h, w), **kw)
    pairs = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 255, (pp["batch"], 2, h, w)).astype(np.float32), device=dev)
    with counted() as launches:
        fn(pairs, split(PRNGKey(0, dev), pp["batch"]))
    assert launches["K1"] == 2 * pp["batch"] and launches["K4"] == 1
    grays = pairs.reshape(2 * pp["batch"], h, w)
    check_k6_views(grays, launches["K6"])
    feats = orb_detect_stack(grays, pp["n_features"])
    ii = torch.arange(0, 2 * pp["batch"], 2, dtype=torch.int32, device=dev)
    check_k4((feats.desc.contiguous(), feats.valid.contiguous(), ii, ii + 1))
    base = np.random.default_rng(42).uniform(
        0, 255, (pp["check_batch"], h, w)).astype(np.float32)
    check = torch.as_tensor(np.stack(
        [base, np.roll(base, pp["roll"], (1, 2))], axis=1), device=dev)
    keys = split(PRNGKey(0, dev), pp["check_batch"])
    hb, _, nb = fn(check, keys)
    assert int(nb.min()) > 20, nb.tolist()
    single = [register_pair(check[i, 0], check[i, 1], keys[i], **kw)
              for i in range(pp["check_batch"])]
    assert torch.equal(torch.stack([p.num_inliers for p in single]), nb)
    assert_h_close(torch.stack([p.h for p in single]), hb)
    h2, _, n2 = make_batched_register(make_mesh((2, 1), devices=[dev, dev]),
                                      (h, w), **kw)(check, keys)
    assert torch.equal(n2, nb)
    assert_h_close(h2, hb)


# ---- gigapixel: the strip compose of a 271 MP canvas ---------------------

def gigapixel_geometry():
    """bench.py's gigapixel cameras, compose ROIs and seam-scale ROIs."""
    g = GIGAPIXEL
    (h, w), focal = g["hw"], g["focal"]
    n = g["rows"] * g["cols"]
    yaw, pitch = (w / focal) * (1 - g["overlap"]), (h / focal) * (
        1 - g["overlap"])
    k = np.tile(np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    rs = np.stack([
        (Rotation.from_euler("y", yaw * (c - (g["cols"] - 1) / 2))
         * Rotation.from_euler("x", pitch * (r - (g["rows"] - 1) / 2))
         ).as_matrix().astype(np.float32)
        for r in range(g["rows"]) for c in range(g["cols"])])
    warper = warps.make_warper("spherical", focal)
    rois = [warper.warp_roi((h, w), k[i], rs[i]) for i in range(n)]
    s = min(1.0, float(np.sqrt(0.1e6 / (h * w))))
    k_seam = k.copy()
    k_seam[:, :2, :] *= s
    seam_hw = (int(round(h * s)), int(round(w * s)))
    warper_s = warps.make_warper("spherical", focal * s)
    return dict(n=n, k=k, rs=rs, warper=warper, warper_s=warper_s, s=s,
                seam_hw=seam_hw, k_seam=k_seam,
                srois=[warper_s.warp_roi(seam_hw, k_seam[i], rs[i])
                       for i in range(n)],
                corners=[r[:2] for r in rois], sizes=[r[2:] for r in rois],
                canvas=warps.result_roi([r[:2] for r in rois],
                                        [r[2:] for r in rois]))


def gigapixel_tiles(seed, n):
    """bench.py's tiles on the card: uniform [0, 256) from one CUDA
    generator, 48 tiles at a time, times the gain 0.75 + 0.5 cos(0.37 i),
    clipped, as u8."""
    h, w = GIGAPIXEL["hw"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    gain = 0.75 + 0.5 * np.cos(np.arange(n) * 0.37)
    tiles = torch.empty((n, h, w, 3), dtype=torch.uint8, device=DEV)
    for c0 in range(0, n, GIGAPIXEL["chunk"]):
        m = min(GIGAPIXEL["chunk"], n - c0)
        t = torch.rand((m, h, w, 3), generator=gen, device=DEV) * 256.0
        g = torch.as_tensor(gain[c0:c0 + m, None, None, None],
                            dtype=torch.float32, device=DEV)
        tiles[c0:c0 + m] = torch.clamp(t * g, 0.0, 255.0).to(torch.uint8)
    return tiles


def gigapixel_prep(tiles, geo):
    """The seam-scale prep: each tile resized to seam scale, cf.warp_stack,
    GAIN_BLOCKS (block 64) by feed_device, dp_color seams."""
    seam = torch.stack([torch.clamp(torch.round(resize(im, geo["seam_hw"])),
                                    0, 255).to(torch.uint8) for im in tiles])
    srois = geo["srois"]
    images_pad, masks_pad = cf.warp_stack(
        seam, torch.as_tensor(geo["k_seam"], device=DEV),
        torch.as_tensor(geo["rs"], device=DEV), geo["warper_s"].scale,
        torch.as_tensor(np.asarray([r[:2] for r in srois], np.float32),
                        device=DEV), "spherical",
        pad_h=-(-max(r[3] for r in srois) // 64) * 64,
        pad_w=-(-max(r[2] for r in srois) // 64) * 64)
    masks_host = masks_pad.cpu().numpy()
    period = warps.u_period("spherical", geo["warper_s"].scale)
    corners = [r[:2] for r in srois]
    comp = feed_device(corners, [r[2:] for r in srois], images_pad,
                       masks_pad, block_size=64, period=period,
                       comp_type=ExposureCompensatorType.GAIN_BLOCKS)
    seam_masks = find_seams(corners, [masks_host[i, :r[3], :r[2]]
                                      for i, r in enumerate(srois)],
                            "dp_color", images_dev=images_pad, period=period)
    return comp, seam_masks


class StripWatch:
    """While open, what the strip compose holds: the finished strips left
    on the card after each hand-off (`_StripFetch.put`) and each K5 call's
    rects and bytes of samples and scratch (`_rect_bytes`)."""

    def __init__(self, cf):
        self.cf, self.pending, self.chunks = cf, [], []
        self.put, self.pa = cf._StripFetch.put, cf.pyramid_accumulate

    def __enter__(self):
        def put(fetch, *args):
            self.put(fetch, *args)
            self.pending.append(len(fetch.pending))

        def pa(warped, weight, offs, accs, nb):
            n, _, ph, pw = warped.shape
            self.chunks.append((n, n * self.cf._rect_bytes(ph, pw, nb)))
            return self.pa(warped, weight, offs, accs, nb)
        self.cf._StripFetch.put, self.cf.pyramid_accumulate = put, pa
        return self

    def __exit__(self, *exc):
        self.cf._StripFetch.put, self.cf.pyramid_accumulate = self.put, self.pa


def u8_diff_stats(a, b, mask):
    """(mean, p99) of |a - b| over the mask for two u8-valued (H, W, 3)
    panoramas, from the exact histogram of the integer differences."""
    d = (a.to(torch.int16) - b.to(torch.int16)).abs_()
    d = torch.where(mask[..., None], d, torch.full_like(d, -1))
    counts = np.array([int((d == v).sum()) for v in range(int(d.max()) + 1)])
    cum = np.cumsum(counts)
    r = 0.99 * (cum[-1] - 1)
    lo = int(np.searchsorted(cum, int(r), side="right"))
    hi = int(np.searchsorted(cum, min(int(r) + 1, cum[-1] - 1), side="right"))
    return (float((counts * np.arange(len(counts))).sum() / cum[-1]),
            lo + (r - int(r)) * (hi - lo))


def case_gigapixel(caps, tmp):
    """bench.py's gigapixel: 12 x 24 tiles of 1024x1536 at focal 6000 made
    on the card, the seam-scale prep, then fused_compose_strips of the
    271.2 MP canvas in strips of 4096 into a u8 host panorama (a warm pass
    on seed 1, the gated pass on seed 2): coverage > 0.5, one finished
    strip on the card after each hand-off, no K5 call past SAMPLE_BUDGET,
    the peak device memory within what was resident plus the design's
    terms and below the tiles plus whole-canvas accumulators; the
    panorama against fused_compose on the same inputs (mask equal, mean
    |diff| < 0.5, p99 <= 2 right of the first strip's margin, where the
    reference's own strips differ from its whole canvas); the banded
    pyrUp of a strip's collapse; K2 and K5 on the first K5 call of the
    strip with the most rects."""
    geo, mb = gigapixel_geometry(), BlenderType.MULTI_BAND
    _, _, cw, ch = geo["canvas"]
    seam_corners = [r[:2] for r in geo["srois"]]
    strip_w, margin, strips = cf.strip_rects(geo["corners"], geo["sizes"],
                                             mb, 5.0, GIGAPIXEL["strip_w"])
    g_whole = cf.compose_rects(geo["corners"], geo["sizes"], mb, 5.0)
    for seed in (1, 2):
        inputs = tiles = None
        torch.cuda.empty_cache()
        tiles = gigapixel_tiles(seed, geo["n"])
        comp, seam_masks = gigapixel_prep(tiles, geo)
        inputs = (tiles, geo["k"], geo["rs"], geo["warper"], geo["corners"],
                  geo["sizes"], seam_masks, seam_corners, geo["s"], comp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        with StripWatch(cf) as watch, counted() as launches:
            pano, mask = cf.fused_compose_strips(
                *inputs, mb, 5.0, strip_w=GIGAPIXEL["strip_w"],
                out_dtype=np.uint8)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    assert pano.shape == (ch, cw, 3) and pano.dtype == np.uint8
    assert mask.mean() > 0.5
    assert 8.0 < float(pano[mask].mean()) < 248.0
    assert len(watch.pending) == len(strips) and max(watch.pending) <= 1
    assert not [c for c in watch.chunks
                if c[0] > 1 and c[1] > cf.SAMPLE_BUDGET], watch.chunks
    assert launches["K2"] > 0 and launches["K5"] > 0, launches
    # The peak against the terms the design allows: the per-image inputs,
    # one strip's accumulators, the sample budget, the largest rect
    # sampled alone with its temporaries, two finished strips.
    base = torch.cuda.memory_allocated()
    inp = cf._sample_inputs(*inputs)
    torch.cuda.synchronize()
    in_bytes = torch.cuda.memory_allocated() - base
    g = max(strips, key=lambda st: max(ph * pw for ph, pw in st.buckets))
    (ph, pw), idxs = max(g.buckets.items(), key=lambda kv: kv[0][0] * kv[0][1])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sample = cf._rect_sample(inp, g, idxs[0], ph, pw)
    torch.cuda.synchronize()
    rect = torch.cuda.max_memory_allocated() - base
    del sample, inp
    nb = strips[0].n_bands
    accs = sum(16 * (strips[0].canvas_h >> b) * (strips[0].canvas_w >> b)
               for b in range(nb + 1))
    assert peak <= resident + in_bytes + accs + cf.SAMPLE_BUDGET + rect + (
        2 * strips[0].canvas[3] * strip_w * 4) + MEM_SLACK, peak
    assert peak < tiles.numel() + sum(
        16 * (g_whole.canvas_h >> b) * (g_whole.canvas_w >> b)
        for b in range(g_whole.n_bands + 1)), peak
    # Against the whole canvas.
    torch.cuda.empty_cache()
    pano_w, mask_w = cf.fused_compose(*inputs, mb, 5.0)
    mask_s = torch.from_numpy(mask).to(DEV)
    assert torch.equal(mask_w, mask_s)
    pano_s = torch.from_numpy(pano).to(DEV)
    assert u8_diff_stats(pano_w, pano_s, mask_w)[0] < 0.5
    assert u8_diff_stats(pano_w[:, margin:], pano_s[:, margin:],
                         mask_w[:, margin:])[1] <= 2.0
    del pano_w, mask_w, mask_s, pano_s, pano, mask
    check_banded_up((strips[0].canvas_h, strips[0].canvas_w), nb)
    # K2 and K5 on the first K5 call of the strip with the most rects.
    g = max(strips, key=lambda st: len(st.tls))
    (ph, pw), idxs = max(g.buckets.items(),
                         key=lambda kv: (kv[0][0] * kv[0][1], len(kv[1])))
    per = max(1, cf.SAMPLE_BUDGET // cf._rect_bytes(ph, pw, g.n_bands))
    g_one = dataclasses.replace(g, buckets={(ph, pw): idxs[:per]})
    with Recorder(cf, "warp_bilinear") as k2:
        warped, weight, offs = next(iter(cf.compose_buckets(*inputs, g_one)))
    assert len(k2.calls["warp_bilinear"]) == warped.shape[0]
    check_k2(k2.calls["warp_bilinear"])
    accs = [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b), device=DEV)
            for b in range(g.n_bands + 1)]
    check_k5([((warped, weight, offs, accs, g.n_bands), {}, None)])


# ---- the other detectors -------------------------------------------------

def check_detector_vs_cpu(feat, gray, got, n_features):
    """The detector on the card (the stitch's features of view 0) against
    the same module on the CPU on the same gray view: equal valid counts;
    >= 99% of the CPU keypoints paired with a card keypoint of the same
    octave within 1e-2 px and 1e-3 rad; >= 99% of the paired descriptors
    within 1e-4 (SIFT, SURF), or (AKAZE) with bits that differ only where
    the two means a bit compares differ by < 1e-3 on the CPU."""
    if feat == "akaze":
        ref, means = akaze.akaze_with_means(gray.cpu(), n_features)
    else:
        ref = (sift_detect_and_describe if feat == "sift" else
               surf_detect_and_describe)(gray.cpu(), n_features)
    got = type(got)(*(getattr(got, name).cpu() for name in (
        "xy", "response", "angle", "octave", "size", "desc", "valid")))
    assert int(ref.valid.sum()) == int(got.valid.sum())
    ri = torch.nonzero(ref.valid)[:, 0]
    gi = torch.nonzero(got.valid)[:, 0]
    turn = torch.remainder(ref.angle[ri, None].double() -
                           got.angle[None, gi].double() + math.pi,
                           2 * math.pi) - math.pi
    near = ((torch.abs(ref.xy[ri, None, 0] - got.xy[None, gi, 0]) <= 1e-2) &
            (torch.abs(ref.xy[ri, None, 1] - got.xy[None, gi, 1]) <= 1e-2) &
            (ref.octave[ri, None] == got.octave[None, gi]) &
            (torch.abs(turn) <= 1e-3))
    paired = near.any(1)
    assert float(paired.float().mean()) >= 0.99
    rp, gp = ri[paired], gi[near.to(torch.uint8).argmax(1)][paired]
    if feat == "akaze":
        chan, bi, bj = (torch.as_tensor(x) for x in akaze.bit_pairs())
        shifts = torch.arange(32, dtype=torch.int32)
        flips = (((ref.desc[rp][:, :, None] >> shifts) ^
                  (got.desc[gp][:, :, None] >> shifts)) & 1).reshape(
                      len(rp), -1)[:, :360].bool()
        gap = torch.abs(means[chan, :, bi] - means[chan, :, bj]).t()[rp]
        ok = ~(flips & (gap >= 1e-3)).any(1)
    else:
        ok = torch.abs(ref.desc[rp] - got.desc[gp]).amax(1) <= 1e-4
    assert float(ok.float().mean()) >= 0.99


def case_detector(feat):
    def case(caps, tmp):
        r = caps["rings"]
        cfg = _cfg(features_type=feat, match_conf=DETECTOR_MATCH_CONF[feat],
                   checkpoint_dir=tmp)

        def run(directory, cfg):
            rec = Recorder(stitcher, "detect_features", "match_all_pairs",
                           "find_seams")
            try:
                with rec, counted() as launches:
                    res = stitcher.stitch(directory, cfg, output="",
                                          device=DEV)
            except RuntimeError as e:
                assert str(e).startswith("Need more images"), e
                res = None
            assert launches["K1"] == 0, launches
            feats = rec.calls["match_all_pairs"][0][0][0]
            assert feats.desc.dtype == (torch.int32 if feat == "akaze"
                                        else torch.float32)
            return res, launches, rec
        res, launches, rec = run(r["default"], cfg)
        if res is None or res.kept_indices != list(range(RING["n_images"])):
            # Every adjacent pair the stitch zeroed was zeroed by the
            # reference's near-duplicate rule (raw confidence > 3); then
            # the detector keeps every view of the sigma-12 ring.
            graph = rec.calls["match_all_pairs"][0][2]
            raw = [float(graph.num_inliers[a, a + 1]) / (
                8.0 + 0.3 * float(graph.num_matches[a, a + 1]))
                for a in range(RING["n_images"] - 1)]
            dropped = [x for a, x in enumerate(raw)
                       if float(graph.confidence[a, a + 1]) == 0.0]
            assert dropped and all(x > 3.0 for x in dropped), raw
            cfg = dataclasses.replace(cfg, **DETECTOR_KEEP[feat])
            res, launches, rec = run(r["noisy"], cfg)
        check_stitch(res, launches, r, RING["hw"],
                     names=("K2", "K5", "K4") if feat == "akaze" else
                     ("K2", "K5"))
        check_seam_union(rec.calls["find_seams"][0])
        if feat == "akaze":
            check_k4(k4_args(rec.calls["match_all_pairs"][0][0][0]))
        (gray, _), _, got = rec.calls["detect_features"][0]
        check_detector_vs_cpu(feat, gray, got, cfg.num_features)
    case.__doc__ = (f"StitchConfig(features_type={feat!r}) on the ring: "
                    f"the stitch's gates, and the detector on the card "
                    f"against the CPU module on view 0.")
    return case


CASES = {
    "work_scale": case_work_scale, "legacy_default": case_legacy_default,
    "default": case_default, "bench_config": case_bench_config,
    "cli": case_cli, "voronoi": case_seams("voronoi"),
    "gc_color": case_seams("gc_color"),
    "gc_colorgrad": case_seams("gc_colorgrad"), "resume": case_resume,
    "no_exif": case_no_exif, "ray": case_ray, "timelapse": case_timelapse,
    "strips": case_strips, "features_70000": case_features_70000,
    "cyl4": case_cyl4, "vga_pair": case_vga_pair,
    "profile_graph": case_profile_graph, "rig37": case_rig37,
    "infill": case_infill, "affine": case_affine, "mixed8": case_mixed8,
    "spher16": case_spher16, "mosaic100": case_mosaic100,
    "gp_sharded": case_gp_sharded, "pairs": case_pairs,
    "gigapixel": case_gigapixel, "sift": case_detector("sift"),
    "surf": case_detector("surf"), "akaze": case_detector("akaze"),
}
SLOW = ("spher16", "gigapixel", "sift", "surf", "akaze")


@pytest.mark.parametrize("case", [
    pytest.param(name, marks=pytest.mark.slow) if name in SLOW else name
    for name in CASES])
def test_card_stitch(case, caps, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    CASES[case](caps, str(tmp_path))
