"""End-to-end stitch: the fused-compose path of
`image_stitching_tpu/pipeline/stitcher.py`.

Stages: read images and EXIF priors (fast ingest: the background native
decode of the codec's 4:2:0 planes, `pipeline/ingest.py`) -> features
(`features_type`: ORB over the stack, kernel K1; SIFT, SURF or AKAZE per
image, `detect_features`) -> all-pairs matching with RANSAC, homography
or affine (binary descriptors by kernel K4, float ones by squared L2)
-> biggest connected component -> camera seed: the priors, or
without them (or with use_sensor_priors=False, or the affine estimator)
the estimate from the match graph -> bundle adjustment (reproj, ray,
affine or none) -> checkpoint -> pose infill of dropped images
(infill_dropped) -> wave correction -> median focal -> seam-scale warp (any
projection) -> exposure compensation -> seams -> compose-scale fused blend,
multiband, FEATHER or NO (kernels K2 and K5) -> result [-> auto-crop].
A compose canvas of `compose_strips_mp` megapixels or more (when that is
above 0) is streamed in vertical strips of `compose_strip_w` columns
(`compose_fused.py::fused_compose_strips`): the device holds one strip's
band accumulators, and the panorama and its mask come back to the host,
where the result, the crop and the written file take them as CPU tensors.
`serialize_data=False` resumes from the checkpoint (`cams.data`,
`indices.data`) with no features, matching or BA; `find_features=False`
takes the EXIF priors (or identity cameras) as the cameras.

Captures of different sizes take the reference's non-uniform branch:
features per image, the seam-scale warp per image (`Warper.warp`, K2), the host
exposure `feed` and the seams on a padded stack of the fractional warped
images.  Such sets, and `timelapse`, compose in the loop: per image the
compose-scale warp (K2), the gain, the seam mask, then the blender
(`ops/blend.py`, multiband through K5) or the timelapser, which writes
each frame to `fixed_<name>` in the working directory.  `crop_result`
cuts the panorama (not its mask) to `ops/crop.py::crop_rect`.

With `use_sharded_compose` and more than one device of the stitch's type
(`parallel/mesh.py::local_devices`: every CUDA device), the canvas is
sharded over a (1, n) mesh of them
(`compose_fused.py::fused_compose_sharded`, `compose_route`), as the
reference shards it over more than one device.  The device is explicit:
`stitch(..., device="cuda")` raises when no GPU is present, and nothing
falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import StitchConfig, WaveCorrectKind
from ..core import exif as exif_mod
from ..core import image_io, persistence
from ..core.logging import (StageTimes, Trace, count, logger, span,
                            stage_timer, trace_stitch)
from ..core.prng import PRNGKey
from ..core.rig import DEFAULT_RIG
from ..estimation.bundle_adjust import bundle_adjust, pack_correspondences
from ..estimation.components import biggest_component
from ..estimation.graph import matches_graph_dot
from ..estimation.homography_estimator import (affine_based_estimate,
                                               homography_based_estimate)
from ..estimation.pose_infill import infill_dropped_cameras
from ..estimation.wave_correct import wave_correct
from ..geometry.camera import Cameras
from ..ops.blend import make_blender
from ..ops.crop import crop_rect
from ..ops.exposure import apply_gain, feed, feed_device
from ..ops.features import (Features, akaze_detect_and_describe,
                            orb_detect_and_describe,
                            sift_detect_and_describe,
                            surf_detect_and_describe)
from ..ops.features.orb import orb_detect_stack
from ..ops.imgproc import dilate3, resize, rgb_to_gray, scale_size
from ..ops.matching import match_all_pairs
from ..ops.seams import find_seams
from ..ops.timelapse import Timelapser, fixed_name
from ..ops.warps import (Warper, make_warper, result_roi, u_period,
                         warper_rotations)
from ..parallel.mesh import local_devices, make_mesh
from .compose_fused import (fused_compose, fused_compose_sharded,
                            fused_compose_strips, warp_stack)
from .ingest import fast_prep, pick_num8, start_fast_ingest

__all__ = ["stitch", "StitchResult", "compose_route", "compose_uniform",
           "compose_inputs",
           "ComposeInputs", "detect_features", "detect_stack"]


@dataclasses.dataclass
class StitchResult:
    # float32 (H, W, 3) RGB and bool (H, W), on the device; on the host
    # (CPU tensors) where the strip-streamed or sharded compose made them.
    panorama: torch.Tensor
    mask: torch.Tensor
    kept_indices: List[int]
    cameras: Cameras                # at work scale
    stage_times: StageTimes
    timelapse_frames: List[str] = dataclasses.field(default_factory=list)
    work_scale: float = 1.0
    # The stitch's spans and counters (`core/logging.py`).
    trace: Optional[Trace] = None


def compose_route(cfg: StitchConfig, canvas, device) -> str:
    """Which compose a same-size stack takes, in the reference's order
    (`stitcher.py:641-660`): "sharded" with use_sharded_compose and more
    than one device of the stitch's type (`local_devices`), "strips" for a
    canvas (x, y, w, h) of compose_strips_mp MP or more (when above 0),
    else "fused"."""
    if cfg.use_sharded_compose and len(local_devices(
            torch.device(device).type)) > 1:
        return "sharded"
    if (cfg.compose_strips_mp > 0
            and canvas[2] * canvas[3] / 1e6 >= cfg.compose_strips_mp):
        return "strips"
    return "fused"


def compose_uniform(args, cfg: StitchConfig, device):
    """Compose `fused_compose`'s arguments by `compose_route`: the canvas
    sharded over a (1, n) mesh of the stitch's devices, streamed in strips,
    or whole.  The sharded and strip composes return the panorama and
    mask as CPU tensors, the whole compose on the stack's device."""
    route = compose_route(cfg, result_roi(args[4], args[5]), device)
    if route == "sharded":
        devs = local_devices(torch.device(device).type)
        mesh = make_mesh((1, len(devs)), ("dp", "sp"), devices=devs)
        return tuple(torch.from_numpy(a)
                     for a in fused_compose_sharded(mesh, *args))
    if route == "strips":
        # The device holds one strip's accumulators; the panorama comes
        # back to the host strip by strip and stays there.
        return tuple(torch.from_numpy(a) for a in fused_compose_strips(
            *args, strip_w=cfg.compose_strip_w))
    return fused_compose(*args)


def detect_features(gray: torch.Tensor, cfg: StitchConfig) -> Features:
    """One (H, W) image's features of `cfg.features_type` (the reference's
    `image_stitching.cpp:542-565` dispatch); an unknown type raises with
    the reference's message."""
    if cfg.features_type == "orb":
        return orb_detect_and_describe(gray, n_features=cfg.num_features,
                                       pattern=cfg.orb_pattern)
    detectors = {"sift": sift_detect_and_describe,
                 "akaze": akaze_detect_and_describe,
                 "surf": surf_detect_and_describe}
    if cfg.features_type not in detectors:
        raise ValueError(
            f"Unknown 2D features type: '{cfg.features_type}'.")
    return detectors[cfg.features_type](gray, n_features=cfg.num_features)


def detect_stack(grays, cfg: StitchConfig) -> Features:
    """Features of each work image, stacked: ORB by `orb_detect_stack`,
    the other detectors image by image."""
    if cfg.features_type == "orb":
        return orb_detect_stack(grays, n_features=cfg.num_features,
                                pattern=cfg.orb_pattern)
    return Features.stack([detect_features(g, cfg) for g in grays])


def _load_priors(paths: Sequence[str]):
    """EXIF ingestion: (numpy camera fields | None, is_portrait); images
    without a prior get identity cameras when any image has one."""
    cams = []
    is_portrait = False
    for p in paths:
        desc = exif_mod.read_image_description(p)
        prior = None
        if desc is not None:
            try:
                prior = exif_mod.parse_image_description(desc)
            except (ValueError, IndexError):
                prior = None
        if prior is None:
            cams.append(None)
            continue
        is_portrait = prior.is_portrait
        cams.append(exif_mod.sensor_prior_to_camera(prior))
    if all(c is None for c in cams):
        return None, False
    ident = (1.0, 1.0, 0.0, 0.0, np.eye(3, dtype=np.float32),
             np.zeros(3, np.float32))
    cols = list(zip(*[c if c is not None else ident for c in cams]))
    return dict(focal=np.asarray(cols[0], np.float32),
                aspect=np.asarray(cols[1], np.float32),
                ppx=np.asarray(cols[2], np.float32),
                ppy=np.asarray(cols[3], np.float32),
                R=np.stack(cols[4]), t=np.stack(cols[5])), is_portrait


def _prior_cameras(priors, work_scale: float, dev) -> Optional[Cameras]:
    """The EXIF priors' cameras at work scale on `dev`, or None."""
    return (Cameras.from_numpy(device=dev, **priors).scaled(work_scale)
            if priors is not None else None)


def _median_focal(focals: np.ndarray) -> float:
    """Sorted middle (odd) / mean of the middle two (even)."""
    f = np.sort(np.asarray(focals, np.float64))
    n = len(f)
    if n % 2 == 1:
        return float(f[n // 2])
    return float(f[n // 2 - 1] + f[n // 2]) * 0.5


@dataclasses.dataclass
class ComposeInputs:
    """Compose-scale cameras and ROIs of the kept images."""
    scale: float                    # compose scale of the full image
    warper: Warper
    ks: np.ndarray                  # (N, 3, 3) float32
    rs: np.ndarray                  # (N, 3, 3) float32, the warper's R
    corners: List[Tuple[int, int]]
    sizes: List[Tuple[int, int]]
    # Compose source size of each image, or None where the sources stay at
    # full resolution.
    resize_hws: Optional[List[Tuple[int, int]]]


def compose_inputs(cameras: Cameras, hws: Sequence[Tuple[int, int]],
                   work_scale: float, compose_megapix: float, warp_type: str,
                   area0: Optional[int] = None) -> ComposeInputs:
    """The compose warper, cameras and per-image ROIs for work-scale
    `cameras` of images of full sizes `hws` (one (h, w) each), as the
    reference's compose stage sets them up.  The compose scale is set by
    `area0`, the pixel count of the capture set's first image (kept or
    not), by default the first (h, w)'s; the sources are resized only when
    it is more than 0.1 away from 1."""
    cam_np = cameras.numpy()
    if area0 is None:
        area0 = hws[0][0] * hws[0][1]
    scale = 1.0
    if compose_megapix > 0:
        scale = min(1.0, float(np.sqrt(compose_megapix * 1e6 / area0)))
    aspect = scale / work_scale
    warper = make_warper(warp_type, _median_focal(cam_np["focal"]) * aspect)
    ks = np.asarray(cameras.scaled(aspect).K().cpu().numpy(), np.float32)
    rs = warper_rotations(warp_type, cam_np["R"])
    resized = abs(scale - 1) > 1e-1
    resize_hws = ([scale_size(h, w, scale) for h, w in hws] if resized
                  else None)
    corners, sizes = [], []
    for i, (h, w) in enumerate(hws):
        src_hw = ((int(round(h * scale)), int(round(w * scale))) if resized
                  else (h, w))
        roi = warper.warp_roi(src_hw, ks[i], rs[i])
        corners.append((roi[0], roi[1]))
        sizes.append((roi[2], roi[3]))
    return ComposeInputs(scale, warper, ks, rs, corners, sizes, resize_hws)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("stitch(device='cuda'): no CUDA device available")
    return device


@contextlib.contextmanager
def _profiled(profile_dir: str, device: torch.device):
    """A torch.profiler trace of the block, written as Chrome trace JSON to
    `profile_dir`/stitch_trace.json (where the reference writes its
    jax.profiler trace); nothing when profile_dir is empty."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "stitch_trace.json"))


def stitch(source, cfg: StitchConfig = StitchConfig(),
           output: Optional[str] = None, device="cuda") -> StitchResult:
    """Stitch a directory or a list of image paths on `device`.  Writes
    `cfg.result_name` (or `output`) unless output=""."""
    dev = _resolve_device(device)
    with _profiled(cfg.profile_dir, dev), trace_stitch() as trace:
        result = _stitch_body(source, cfg, output, dev)
    result.trace = trace
    return result


def _stitch_body(source, cfg: StitchConfig, output: Optional[str],
                 dev: torch.device) -> StitchResult:
    paths = (image_io.list_images(source) if isinstance(source, str)
             else list(source))
    if len(paths) < 2:
        raise ValueError("Need at least two images to stitch")
    times: StageTimes = {}
    # Resuming (serialize_data=False) or taking the priors as the cameras
    # (find_features=False) detects no features.
    want_feats = cfg.find_features and cfg.serialize_data

    fast = None
    device_imgs = None
    with stage_timer("Reading images and priors", times, dev):
        with span("priors"):
            priors, is_portrait = (_load_priors(paths)
                                   if cfg.use_sensor_priors
                                   else (None, False))
        # Header-only sizes: the three scales are known before any pixel
        # is decoded, so the decoder can run DCT-scaled.
        with span("probe sizes"):
            full_sizes = [image_io.probe_oriented_size(p, is_portrait)
                          for p in paths]
        area0 = full_sizes[0][0] * full_sizes[0][1]
        work_scale = 1.0 if cfg.work_megapix < 0 else min(
            1.0, float(np.sqrt(cfg.work_megapix * 1e6 / area0)))
        if cfg.work_scale_snap and work_scale < 1.0:
            num8 = pick_num8(work_scale)
            if num8 % 2 == 1 and num8 < 8:
                num8 += 1
            work_scale = num8 / 8.0
        seam_scale = min(1.0, float(np.sqrt(cfg.seam_megapix * 1e6 / area0)))
        seam_work_aspect = seam_scale / work_scale
        compose_scale = 1.0
        if cfg.compose_megapix > 0:
            compose_scale = min(1.0, float(
                np.sqrt(cfg.compose_megapix * 1e6 / area0)))
        # The compose skips its resize within 10% of scale 1, and then
        # reads full-resolution pixels.
        compose_src_scale = (compose_scale
                             if abs(compose_scale - 1) > 1e-1 else 1.0)
        # The timelapse composes in the loop, from full-resolution pixels.
        if cfg.fast_ingest and not cfg.timelapse:
            with span("start decode") as started:
                fast = start_fast_ingest(
                    paths, is_portrait, want_gray=want_feats,
                    gray_scale=work_scale,
                    rgb_scale=max(seam_scale, compose_src_scale), device=dev)
                if fast is not None:
                    started.annotate(threads=fast.threads)
        with span("upload"):
            if fast is not None:
                gray_raw, rgb_raw = fast.upload()
            else:
                # The legacy route decodes each file here, then uploads it.
                device_imgs = []
                for p in paths:
                    im = image_io.orient_capture(image_io.imread(p),
                                                 is_portrait)
                    count("ingest.upload_bytes", im.nbytes)
                    device_imgs.append(torch.from_numpy(im).to(dev))
                full_sizes = [(im.shape[1], im.shape[0])
                              for im in device_imgs]
    n = len(paths)
    uniform = len(set(full_sizes)) == 1

    stack_u8 = seam_stack = None
    seam_imgs: List[torch.Tensor] = []     # the non-uniform branch's
    with stage_timer("Finding features", times, dev):
        h0, w0 = full_sizes[0][1], full_sizes[0][0]
        seam_hw = scale_size(h0, w0, seam_scale)
        if fast is not None:
            # stack_u8 is at decode scale; the compose resizes it to dims
            # computed from the full-resolution size.
            work_hw = (scale_size(h0, w0, work_scale) if work_scale != 1.0
                       else (h0, w0))
            with span("fast_prep"):
                grays, stack_u8, seam_stack = fast_prep(
                    fast, gray_raw, rgb_raw, is_portrait, work_hw, seam_hw)
        else:
            grays, seam_list = [], []
            for im in device_imgs:
                h, w = im.shape[0], im.shape[1]
                if want_feats:
                    work = (resize(im, scale_size(h, w, work_scale))
                            if work_scale != 1.0 else im.to(torch.float32))
                    grays.append(rgb_to_gray(work))
                if uniform:
                    seam_list.append(torch.clamp(torch.round(
                        resize(im, seam_hw)), 0, 255).to(torch.uint8))
                else:
                    # Each image at its own seam size, left fractional.
                    seam_imgs.append(resize(im, scale_size(h, w,
                                                           seam_scale)))
            if uniform:
                seam_stack = torch.stack(seam_list)
                stack_u8 = torch.stack(device_imgs)
        if want_feats:
            fstack = detect_stack(grays, cfg)

    if want_feats:
        with stage_timer("Pairwise matching", times, dev):
            graph = match_all_pairs(fstack, PRNGKey(cfg.seed, dev),
                                    match_conf=cfg.match_conf,
                                    range_width=cfg.range_width,
                                    pair_cap=cfg.num_features,
                                    matcher_type=cfg.matcher_type)
            with span("matches to host"):
                pm = graph.numpy()
                xy_host = fstack.xy.cpu().numpy()
        with stage_timer("Selecting images", times, dev):
            cameras_all = _prior_cameras(priors, work_scale, dev)
            if cfg.save_graph and cfg.save_graph_to:
                with open(cfg.save_graph_to, "w") as gf:
                    gf.write(matches_graph_dot(paths, pm.confidence,
                                               pm.num_inliers,
                                               pm.num_matches,
                                               cfg.conf_thresh))
            indices, removed = biggest_component(pm.confidence,
                                                 cfg.conf_thresh)
            if removed:
                logger.info("Removed some images, because can't match them "
                            "or there are too similar images: (%s).",
                            ", ".join(str(i + 1) for i in removed))
            if len(indices) < 2:
                raise RuntimeError("Need more images: all but one were "
                                   "removed as unmatchable")

            # The seed: the priors, else (and always for the affine
            # estimator) the estimate from the kept images' match graph.
            pm_sub = pm.subset(indices)
            if cameras_all is not None and cfg.estimator_type != "affine":
                seed_cams = cameras_all[indices]
            else:
                estimate = (affine_based_estimate
                            if cfg.estimator_type == "affine"
                            else homography_based_estimate)
                sizes_sub = [scale_size(full_sizes[i][1], full_sizes[i][0],
                                        work_scale) for i in indices]
                seed_cams = Cameras.from_numpy(device=dev, **estimate(
                    pm_sub, sizes_sub, cfg.conf_thresh))
        with stage_timer("Bundle adjustment", times, dev):
            with span("pack"):
                problem = pack_correspondences(xy_host[np.asarray(indices)],
                                               pm_sub, cfg.conf_thresh)
            cameras = bundle_adjust(seed_cams, problem,
                                    cost_func=cfg.ba_cost_func,
                                    refine_mask=cfg.ba_refine_mask)
        with stage_timer("Saving checkpoint", times, dev):
            persistence.serialize_camera_params(cameras, cfg.checkpoint_dir)
            persistence.serialize_indices(indices, cfg.checkpoint_dir)
            if cfg.checkpoint_npz:
                np.savez(os.path.join(cfg.checkpoint_dir, "cameras.npz"),
                         indices=np.asarray(indices), **cameras.numpy())
        if cfg.infill_dropped and cameras_all is not None and \
                len(indices) < n:
            with stage_timer("Infilling dropped cameras", times, dev):
                # The ring-aware neighbour search applies to the rig's own
                # 37-image captures.
                rig = DEFAULT_RIG if n == DEFAULT_RIG.total_images else None
                cameras = Cameras.from_numpy(
                    device=dev, **infill_dropped_cameras(
                        cameras_all.numpy(), cameras.numpy(), indices, rig))
                indices = list(range(n))
    elif cfg.find_features:
        with stage_timer("Reading checkpoint", times, dev):
            indices = persistence.deserialize_indices(cfg.checkpoint_dir)
            cameras = persistence.deserialize_camera_params(
                cfg.checkpoint_dir, device=dev)
    else:
        with stage_timer("Selecting images", times, dev):
            cameras_all = _prior_cameras(priors, work_scale, dev)
            indices = list(range(n))
            cameras = (cameras_all if cameras_all is not None
                       else Cameras.identity(n, float(np.mean(
                           [s[0] for s in full_sizes])), device=dev))

    with stage_timer("Wave correction", times, dev):
        if cfg.do_wave_correct and cfg.wave_correct != WaveCorrectKind.NO:
            cameras = dataclasses.replace(
                cameras, R=wave_correct(cameras.R, cfg.wave_correct))
        paths = [paths[i] for i in indices]
        full_sizes = [full_sizes[i] for i in indices]
        if uniform:
            sel = torch.as_tensor(indices, device=dev)
            stack_u8 = stack_u8[sel]
            seam_stack = seam_stack[sel]
        else:
            device_imgs = [device_imgs[i] for i in indices]
            seam_imgs = [seam_imgs[i] for i in indices]
        n = len(indices)
        cam_np = cameras.numpy()
        warped_image_scale = _median_focal(cam_np["focal"])
    with stage_timer("Warping images", times, dev):
        swa = seam_work_aspect
        warper = make_warper(cfg.warp_type, warped_image_scale * swa)
        k_all = np.asarray(cameras.K().cpu().numpy(), np.float32)
        k_seam = k_all.copy()
        k_seam[:, 0, :] *= swa
        k_seam[:, 1, :] *= swa
        r_all = warper_rotations(cfg.warp_type, cam_np["R"])
        seam_shapes = ([seam_hw] * n if uniform else
                       [tuple(im.shape[:2]) for im in seam_imgs])
        rois = [warper.warp_roi(seam_shapes[i], k_seam[i], r_all[i])
                for i in range(n)]
        corners = [(r[0], r[1]) for r in rois]
        images_warped = None
        if uniform:
            # Snap to 64, as the reference does: the pad sizes change
            # which pixels the padded stack holds, hence the output.  The
            # stacks stay on the device for the exposure statistics and
            # the seams.
            pad_h = -(-max(r[3] for r in rois) // 64) * 64
            pad_w = -(-max(r[2] for r in rois) // 64) * 64
            with span("warp_stack", n=n, h=seam_hw[0], w=seam_hw[1],
                      pad_h=pad_h, pad_w=pad_w):
                images_pad, masks_pad = warp_stack(
                    seam_stack, torch.as_tensor(k_seam, device=dev),
                    torch.as_tensor(r_all, device=dev), warper.scale,
                    torch.as_tensor(np.asarray([[r[0], r[1]] for r in rois],
                                               np.float32), device=dev),
                    warper.proj_name, pad_h=pad_h, pad_w=pad_w)
            with span("masks to host"):
                masks_host = masks_pad.cpu().numpy()
            masks_warped = [masks_host[i, :rois[i][3], :rois[i][2]]
                            for i in range(n)]
        else:
            # Each image warped alone; the seams read the fractional warped
            # images from one padded stack, each rect at the origin.
            images_pad = torch.zeros(
                (n, max(r[3] for r in rois), max(r[2] for r in rois), 3),
                dtype=torch.float32, device=dev)
            images_warped, masks_warped = [], []
            for i, im in enumerate(seam_imgs):
                _, img_w = warper.warp(im, k_seam[i], r_all[i],
                                       dst_roi=rois[i])
                _, mask_w = warper.warp(
                    torch.full(im.shape[:2], 255, dtype=torch.uint8,
                               device=dev), k_seam[i], r_all[i],
                    interp="nearest", border="constant", dst_roi=rois[i])
                images_pad[i, :rois[i][3], :rois[i][2]] = img_w
                images_warped.append(img_w.cpu().numpy())
                masks_warped.append(mask_w.cpu().numpy().astype(np.uint8))

    # Cross-dateline pairs of a full ring sit a u-period apart; the period
    # re-couples them for exposure and seams.
    seam_u_period = u_period(warper.proj_name, warper.scale)
    with stage_timer("Compensating exposure", times, dev):
        expos = dict(comp_type=cfg.expos_comp_type,
                     nr_feeds=cfg.expos_comp_nr_feeds,
                     nr_filtering=cfg.expos_comp_nr_filtering,
                     block_size=cfg.expos_comp_block_size,
                     period=seam_u_period)
        if uniform:
            compensator = feed_device(corners, [(r[2], r[3]) for r in rois],
                                      images_pad, masks_pad, **expos)
        else:
            compensator = feed(corners, images_warped, masks_warped, **expos)

    with stage_timer("Finding seams", times, dev):
        seam_masks = find_seams(corners, masks_warped, cfg.seam_find_type,
                                images_dev=images_pad, period=seam_u_period)

    timelapse_frames: List[str] = []
    with stage_timer("Compositing", times, dev):
        comp = compose_inputs(cameras, [(h, w) for w, h in full_sizes],
                              work_scale, cfg.compose_megapix, cfg.warp_type,
                              area0)
        seam_ratio = seam_work_aspect * work_scale / comp.scale
        if uniform and not cfg.timelapse:
            comp_imgs = stack_u8
            if comp.resize_hws is not None:
                with span("resize"):
                    comp_imgs = torch.stack([resize(im, hw) for im, hw in
                                             zip(stack_u8, comp.resize_hws)])
            pano, pano_mask = compose_uniform(
                (comp_imgs, comp.ks, comp.rs, comp.warper, comp.corners,
                 comp.sizes, seam_masks, corners, seam_ratio, compensator,
                 cfg.blend_type, cfg.blend_strength), cfg, dev)
        else:
            sources = list(stack_u8) if uniform else device_imgs
            frames = _loop_compose(sources, comp, seam_masks, compensator,
                                   cfg, dev, paths)
            if cfg.timelapse:
                timelapse_frames = frames
                pano = torch.zeros((1, 1, 3), dtype=torch.float32,
                                   device=dev)
                pano_mask = torch.zeros((1, 1), dtype=torch.bool, device=dev)
            else:
                pano, pano_mask = frames
                pano = torch.clamp(pano, 0.0, 255.0)

    with stage_timer("Writing result", times, dev):
        if cfg.crop_result and not cfg.timelapse:
            x, y, w, h = crop_rect(pano.cpu().numpy())
            pano = pano[y:y + h, x:x + w]
        if not cfg.timelapse:
            out = output if output is not None else cfg.result_name
            if out:
                image_io.imwrite(out, pano.cpu().numpy())
    return StitchResult(panorama=pano, mask=pano_mask,
                        kept_indices=list(indices), cameras=cameras,
                        stage_times=times, timelapse_frames=timelapse_frames,
                        work_scale=work_scale)


def _loop_compose(sources: Sequence[torch.Tensor], comp: ComposeInputs,
                  seam_masks: Sequence[np.ndarray], compensator,
                  cfg: StitchConfig, dev: torch.device, paths: Sequence[str]):
    """The reference's per-image compose, for mixed sizes and the
    timelapse: each full-resolution source resized to compose scale,
    warped with its mask onto its compose ROI, its gain applied, its seam
    mask dilated, resized to the warped rect and cut by the warped mask;
    then fed to the blender, or pasted by the timelapser and written to
    `fixed_<name>` in the working directory.  Returns the blender's
    (panorama, mask), or the timelapse's frame names."""
    if cfg.timelapse:
        sink = Timelapser(comp.corners, comp.sizes, cfg.timelapse_type, dev)
    else:
        sink = make_blender(comp.corners, comp.sizes, cfg.blend_type,
                            cfg.blend_strength, dev)
    frames = []
    for i, img in enumerate(sources):
        logger.info("Compositing image #%d", i + 1)
        if comp.resize_hws is not None:
            img = resize(img, comp.resize_hws[i])
        roi = comp.corners[i] + comp.sizes[i]
        corner, img_w = comp.warper.warp(img, comp.ks[i], comp.rs[i],
                                         dst_roi=roi)
        _, mask_w = comp.warper.warp(
            torch.full(img.shape[:2], 255, dtype=torch.uint8, device=dev),
            comp.ks[i], comp.rs[i], interp="nearest", border="constant",
            dst_roi=roi)
        img_w = apply_gain(compensator, i, img_w)
        seam_m = dilate3(torch.as_tensor(seam_masks[i], device=dev))
        seam_m = resize(seam_m.to(torch.float32), tuple(mask_w.shape))
        final_mask = (seam_m > 127) & (mask_w > 0)
        if cfg.timelapse:
            frames.append(fixed_name(paths[i]))
            image_io.imwrite(frames[-1], sink.process(
                img_w, None, corner).cpu().numpy())
        else:
            sink.feed(img_w, final_mask, corner)
    return frames if cfg.timelapse else sink.blend()
