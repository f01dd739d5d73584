"""Port parity of the registration variants, end to end: both stitch()es
on the same captures, the port drawing its own RANSAC numbers from the
reference's keys (`core/prng.py`).

A 3-image ring of 180x240 (55 deg FOV, 0.55 overlap, sigma-4 noise) and
three configurations: written without EXIF, so the cameras are seeded by
`homography_based_estimate` (`no_exif`); the same files in the affine
(scan) mode, matcher, estimator, bundle adjustment and warp all affine
and no wave correction (`affine`); and with EXIF priors and its last frame
replaced by uniform noise, so the component filter drops it and
infill_dropped=True makes its camera from its neighbour's (`infill`).

In the affine mode the panorama is not held to the reference's: its fused
path samples the plane map of each camera's raw similarity A, away from
the ROIs its warper computes, and the warper maps by OpenCV's convention
(R taking the common frame to the image) where the affine estimator and
bundle adjuster give A from the image to the common frame; its canvas is
0.55 covered on this ring.  The port converts A for the warper
(`ops/warps.py::warper_rotations`) and splits it in the maps as in the
ROIs (`camera_backward_xy`), so the test holds every compose map to the
exact inverse of its camera's A instead."""

import numpy as np
import pytest

from _torch_port import checked_keys, n, rel_rotation_deg
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.pipeline import compose_fused
from image_stitching_tpu_torch.pipeline.stitcher import compose_inputs, stitch

HW = (180, 240)
N_IMAGES = 3
SMALL = dict(num_features=400, compose_megapix=-1, seam_megapix=0.02)
AFFINE = dict(matcher_type="affine", estimator_type="affine",
              ba_cost_func="affine", warp_type="affine",
              do_wave_correct=False)
CASES = {
    "no_exif": ("plain", {}),
    "affine": ("plain", AFFINE),
    "infill": ("noise", dict(infill_dropped=True)),
}


@pytest.fixture(scope="module")
def capture_dirs(tmp_path_factory):
    """The ring without EXIF ("plain"), and with EXIF and frame 2 replaced
    by uniform noise ("noise")."""
    images, k, rs = make_ring_captures(n_images=N_IMAGES, hw=HW, fov_deg=55,
                                       overlap_ratio=0.55)
    plain = tmp_path_factory.mktemp("plain")
    write_capture_dir(str(plain), images, k, rs, with_exif=False)
    noisy = list(images)
    noisy[2] = np.random.default_rng(9).uniform(
        0, 255, images[2].shape).astype(np.float32)
    noise = tmp_path_factory.mktemp("noise")
    write_capture_dir(str(noise), noisy, k, rs)
    return {"plain": str(plain), "noise": str(noise)}, rs


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request, capture_dirs, tmp_path_factory):
    dirs, rs = capture_dirs
    which, extra = CASES[request.param]
    cfg = dict(SMALL, **extra)
    run_j = tmp_path_factory.mktemp("run_jax")
    run_t = tmp_path_factory.mktemp("run_torch")
    ref = jstitch(dirs[which], JConfig(checkpoint_dir=str(run_j), **cfg),
                  output="")
    # Record what the compose hands kernel K2, call by call.
    k2_calls = []
    warp_bilinear = compose_fused.warp_bilinear

    def recording(img, sx, sy):
        k2_calls.append((sx.clone(), sy.clone()))
        return warp_bilinear(img, sx, sy)
    compose_fused.warp_bilinear = recording
    # Every pair i < j is matched: 3 pairs.
    try:
        with checked_keys(JConfig().seed, 3) as drawn:
            got = stitch(dirs[which], StitchConfig(
                checkpoint_dir=str(run_t), **cfg), output="", device="cpu")
    finally:
        compose_fused.warp_bilinear = warp_bilinear
    assert drawn[0] == 3
    return request.param, ref, got, rs, str(run_t), (cfg, k2_calls)


def test_kept_indices_equal(both):
    """Every image comes back in both; with infill the noise frame was
    dropped first (the checkpoint holds the two kept images)."""
    name, ref, got, _, run, _ = both
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))
    with open(f"{run}/indices.data") as f:
        saved = f.read().split()
    assert len(saved) == (2 if name == "infill" else N_IMAGES)


def test_cameras_match_reference(both):
    """The e2e tolerances of tests/test_torch_e2e.py: focal rtol 1e-3 and
    relative rotations within 0.05 degrees; in the affine mode, where R
    holds each image's similarity into image 0's frame, the similarities'
    rotations within 0.05 degrees, scales rtol 1e-3 and translations
    within 1e-3 of the image width."""
    name, ref, got, rs, _, _ = both
    cams = got.cameras.numpy()
    np.testing.assert_allclose(cams["focal"], np.asarray(ref.cameras.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.cameras.R)
    if name == "affine":
        for g, w in zip(cams["R"], rr):
            ang = np.degrees(np.arctan2(g[1, 0], g[0, 0]) -
                             np.arctan2(w[1, 0], w[0, 0]))
            assert abs(ang) <= 0.05
            np.testing.assert_allclose(np.hypot(g[0, 0], g[1, 0]),
                                       np.hypot(w[0, 0], w[1, 0]),
                                       rtol=1e-3)
            np.testing.assert_allclose(g[:2, 2], w[:2, 2], rtol=0,
                                       atol=1e-3 * HW[1])
        return
    for a in range(N_IMAGES - 1):
        ang = rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                               rr[a + 1] @ rr[a].T)
        assert ang <= 0.05, (a, ang)
    if name == "infill":
        # The noise frame's camera, made from its neighbour's and the
        # priors, against the ground truth.  (Without priors the seed's
        # autocalib focal sets the angles, in the reference as well.)
        assert rel_rotation_deg(cams["R"][2] @ cams["R"][1].T,
                                rs[2] @ rs[1].T) < 1.0


def _affine_maps_gate(got, cfg, k2_calls):
    """Every compose rect's K2 map (sx, sy) within 1e-3 px of the exact
    A^-1 of its camera, in float64, on its valid pixels; the panorama
    covers more than 0.9 of its canvas."""
    comp = compose_inputs(got.cameras, [HW] * len(got.kept_indices),
                          got.work_scale, -1, "affine")
    cfg = StitchConfig(**cfg)
    g = compose_fused.compose_rects(comp.corners, comp.sizes,
                                    cfg.blend_type, cfg.blend_strength)
    order = [i for _, idxs in sorted(g.buckets.items()) for i in idxs]
    assert len(order) == len(k2_calls) == N_IMAGES
    cams = got.cameras.numpy()["R"].astype(np.float64)
    for i, (sx, sy) in zip(order, k2_calls):
        h, w = sx.shape
        vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
        uu += g.tls[i][0]
        vv += g.tls[i][1]
        inv = np.linalg.inv(cams[i])
        want_x = inv[0, 0] * uu + inv[0, 1] * vv + inv[0, 2]
        want_y = inv[1, 0] * uu + inv[1, 1] * vv + inv[1, 2]
        inside = ((want_x >= 0) & (want_x <= HW[1] - 1) & (want_y >= 0)
                  & (want_y <= HW[0] - 1))
        assert inside.mean() > 0.3
        assert np.abs(n(sx)[inside] - want_x[inside]).max() <= 1e-3
        assert np.abs(n(sy)[inside] - want_y[inside]).max() <= 1e-3
    assert float(got.mask.float().mean()) > 0.9


def test_panorama_matches_reference(both):
    """Shape within 2 px per axis; mean |difference| <= 2 on the common
    mask.  In the affine mode (see above) the compose maps are held to the
    cameras instead."""
    name, ref, got, _, _, (cfg, k2_calls) = both
    if name == "affine":
        _affine_maps_gate(got, cfg, k2_calls)
        return
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0


def test_no_features_without_priors_takes_identity_cameras(capture_dirs,
                                                           tmp_path):
    """find_features=False on captures without priors: every image, with
    the reference's identity cameras (focal the mean capture width,
    principal point 0, R = I), and the same panorama within 2 px per axis
    and mean |difference| <= 2."""
    dirs, _ = capture_dirs
    cfg = dict(SMALL, find_features=False)
    ref = jstitch(dirs["plain"], JConfig(checkpoint_dir=str(tmp_path), **cfg),
                  output="")
    got = stitch(dirs["plain"], StitchConfig(checkpoint_dir=str(tmp_path),
                                             **cfg), output="", device="cpu")
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))
    cams = got.cameras.numpy()
    for name in ("focal", "aspect", "ppx", "ppy", "R", "t"):
        np.testing.assert_allclose(cams[name],
                                   np.asarray(getattr(ref.cameras, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert float(cams["focal"][0]) == HW[1]
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0
