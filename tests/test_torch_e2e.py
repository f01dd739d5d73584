"""Port parity of the whole slice: both stitch()es on the same captures.

The captures are tests/test_pipeline_e2e.py's (3 images of 160x224, ring
55 deg FOV, 0.55 overlap, sigma-4 noise).  Three configurations: its
small_cfg with no exposure compensation, the "no" seam finder and the
legacy uniform decode path (`both`); small_cfg(fast_ingest=False), the
reference defaults with GAIN_BLOCKS exposure and DP colour seams
(`both_default`); and small_cfg itself, fast ingest on, at full scale and
with the work scale snapped to 6/8 (`both_fast`)."""

import contextlib
import os

import numpy as np
import pytest

import torch

from _torch_port import checked_keys, n, rel_rotation_deg
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.ops import exposure as jexposure
from image_stitching_tpu.ops import seams as jseams
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.core import image_io
from image_stitching_tpu_torch.core.logging import Recorder
from image_stitching_tpu_torch.ops.warps import backward_xy_1d
from image_stitching_tpu_torch.pipeline import compose_fused, ingest, stitcher
from image_stitching_tpu_torch.pipeline.stitcher import (compose_inputs,
                                                         stitch)

HW = (160, 224)
N_IMAGES = 3
SMALL = dict(num_features=400, compose_megapix=-1, seam_megapix=0.02,
             fast_ingest=False)
SLICE = dict(SMALL, expos_comp_type="no", seam_find_type="no")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("captures")
    images, k, rs = make_ring_captures(n_images=N_IMAGES, hw=HW, fov_deg=55,
                                       overlap_ratio=0.55)
    write_capture_dir(str(d), images, k, rs)
    return d, rs


@pytest.fixture(scope="module")
def both(captures, tmp_path_factory):
    d, rs = captures
    run_j = tmp_path_factory.mktemp("run_jax")
    run_t = tmp_path_factory.mktemp("run_torch")
    ref = jstitch(str(d), JConfig(checkpoint_dir=str(run_j), **SLICE),
                  output="")
    # Record what the compose hands kernel K2, call by call.
    k2_calls = []
    warp_bilinear = compose_fused.warp_bilinear

    def recording(img, sx, sy):
        k2_calls.append((img.clone(), sx.clone(), sy.clone()))
        return warp_bilinear(img, sx, sy)
    compose_fused.warp_bilinear = recording
    try:
        got = stitch(str(d), StitchConfig(checkpoint_dir=str(run_t),
                                          **SLICE),
                     output=str(run_t / "result.jpg"), device="cpu")
    finally:
        compose_fused.warp_bilinear = warp_bilinear
    return ref, got, rs, run_t, str(d), k2_calls


def test_kept_indices_and_outputs(both):
    ref, got, _, run, _, _ = both
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))
    for name in ("result.jpg", "cams.data", "indices.data"):
        assert os.path.exists(run / name)


def test_cameras_match_reference(both):
    """Relative rotations within 0.05 degrees, focal rtol 1e-3."""
    ref, got, _, _, _, _ = both
    cams = got.cameras.numpy()
    np.testing.assert_allclose(cams["focal"], np.asarray(ref.cameras.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.cameras.R)
    for a in range(N_IMAGES - 1):
        ang = rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                               rr[a + 1] @ rr[a].T)
        assert ang <= 0.05, (a, ang)


def test_rotation_accuracy_vs_ground_truth(both):
    """The bound of test_pipeline_e2e.test_rotation_accuracy_vs_ground_truth
    (0.8 degrees, sigma-4 sensor noise) holds for the port."""
    _, got, rs, _, _, _ = both
    rc = got.cameras.numpy()["R"]
    for a in range(N_IMAGES - 1):
        assert rel_rotation_deg(rc[a + 1] @ rc[a].T,
                                rs[a + 1] @ rs[a].T) < 0.8


def test_panorama_matches_reference(both):
    """Shape within 2 px per axis; mean |difference| <= 2 on the common
    mask."""
    ref, got, _, _, _, _ = both
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0


def test_compose_geometry_reproduces_k2_inputs(both):
    """compose_inputs + compose_rects + rect_grid, applied to a stitch's
    cameras, give exactly the (img, sx, sy) the compose passed to K2, in
    its order: what the GPU smoke checks K2 on is the main path's input."""
    _, got, _, _, caps, k2_calls = both
    cfg = StitchConfig(**SLICE)
    comp = compose_inputs(got.cameras, [HW] * N_IMAGES, got.work_scale,
                          cfg.compose_megapix, cfg.warp_type)
    g = compose_fused.compose_rects(comp.corners, comp.sizes, cfg.blend_type,
                                    cfg.blend_strength)
    paths = image_io.list_images(caps)
    expect = []
    for (bh, bw), idxs in sorted(g.buckets.items()):
        for i in idxs:
            img = torch.from_numpy(image_io.orient_capture(
                image_io.imread(paths[got.kept_indices[i]]), False))
            us, vs = compose_fused.rect_grid(g.tls[i], bh, bw, "cpu")
            sx, sy, _ = backward_xy_1d(comp.warper.proj_name, us, vs,
                                       torch.as_tensor(comp.ks[i]),
                                       torch.as_tensor(comp.rs[i]),
                                       comp.warper.scale)
            expect.append((img.to(torch.float32), sx, sy))
    assert len(expect) == len(k2_calls) == N_IMAGES
    for want, seen in zip(expect, k2_calls):
        for a, b in zip(want, seen):
            np.testing.assert_array_equal(n(a), n(b))


@pytest.fixture(scope="module")
def both_default(captures, tmp_path_factory):
    """Both stitch()es with the reference defaults but fast ingest
    (GAIN_BLOCKS, dp_color), recording each side's compensator and seam
    masks, what the port's stitch hands the compose, and what the compose
    hands K5 (one call per bucket)."""
    d, rs = captures
    run_j = tmp_path_factory.mktemp("run_jax_default")
    run_t = tmp_path_factory.mktemp("run_torch_default")
    recs = [Recorder(jexposure, "feed_device"), Recorder(jseams, "find_seams"),
            Recorder(stitcher, "feed_device", "find_seams", "fused_compose"),
            Recorder(compose_fused, "pyramid_accumulate")]
    with contextlib.ExitStack() as stack:
        for rec in recs:
            stack.enter_context(rec)
        ref = jstitch(str(d), JConfig(checkpoint_dir=str(run_j), **SMALL),
                      output="")
        got = stitch(str(d), StitchConfig(checkpoint_dir=str(run_t),
                                          **SMALL), output="", device="cpu")
    assert StitchConfig(**SMALL).expos_comp_type.value == "gain_blocks"
    assert StitchConfig(**SMALL).seam_find_type == "dp_color"

    def results(rec, name):
        return [out for _, _, out in rec.calls[name]]
    seen_j = {"comp": results(recs[0], "feed_device"),
              "seams": results(recs[1], "find_seams")}
    seen_t = {"comp": results(recs[2], "feed_device"),
              "seams": results(recs[2], "find_seams"),
              "compose": [args for args, _, _ in
                          recs[2].calls["fused_compose"]],
              "k5": [args[:3] for args, _, _ in
                     recs[3].calls["pyramid_accumulate"]]}
    return ref, got, rs, seen_j, seen_t


def test_default_kept_indices_and_cameras(both_default):
    """Equal kept indices; relative rotations within 0.05 degrees and focal
    rtol 1e-3, as for the no-exposure slice."""
    ref, got, rs, _, _ = both_default
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))
    cams = got.cameras.numpy()
    np.testing.assert_allclose(cams["focal"], np.asarray(ref.cameras.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.cameras.R)
    for a in range(N_IMAGES - 1):
        ang = rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                               rr[a + 1] @ rr[a].T)
        assert ang <= 0.05, (a, ang)


def test_default_gains_match_reference(both_default):
    """GAIN_BLOCKS gain maps rtol 1e-4, grid sizes equal."""
    _, _, _, seen_j, seen_t = both_default
    (cj,), (ct,) = seen_j["comp"], seen_t["comp"]
    # The reference returns (compensator, mask bits) when it carries the
    # warped masks' download along (`extra`).
    cj = cj[0] if isinstance(cj, tuple) else cj
    np.testing.assert_array_equal(ct.grid_sizes, cj.grid_sizes)
    np.testing.assert_allclose(ct.gains, np.asarray(cj.gains), rtol=1e-4)
    assert np.all(np.isfinite(ct.gains))
    assert np.all(ct.gains[ct.gains != 0] > 0)


def test_default_seam_masks_equal(both_default):
    """The DP seam masks are equal pixel for pixel and cut the overlaps."""
    _, _, _, seen_j, seen_t = both_default
    (mj,), (mt,) = seen_j["seams"], seen_t["seams"]
    assert len(mt) == len(mj) == N_IMAGES
    for a, b in zip(mj, mt):
        np.testing.assert_array_equal(np.asarray(b) > 0, np.asarray(a) > 0)
    assert sum(int((np.asarray(m) == 0).sum()) for m in mt) > 0


def test_default_panorama_matches_reference(both_default):
    """Shape within 2 px per axis; mean |difference| <= 2 on the common
    mask."""
    ref, got, _, _, _ = both_default
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0


def test_compose_samples_reproduce_k5_inputs(both_default):
    """compose_buckets (compose_samples stacked per bucket), given what the
    stitch handed fused_compose, yields exactly the (warped, weight,
    offsets) of each K5 call the compose made, one call per bucket, in its
    order: what the GPU smoke checks K5 on is the main path's input."""
    _, _, _, _, seen_t = both_default
    (args,) = seen_t["compose"]
    (images, ks, rs, warper, corners, sizes, seam_masks, seam_corners,
     seam_ratio, compensator, blend_type, blend_strength) = args
    assert compensator.comp_type.value == "gain_blocks"
    g = compose_fused.compose_rects(corners, sizes, blend_type,
                                    blend_strength)
    expect = list(compose_fused.compose_buckets(
        images, ks, rs, warper, corners, sizes, seam_masks, seam_corners,
        seam_ratio, compensator, g))
    assert len(expect) == len(seen_t["k5"]) == len(g.buckets)
    assert sum(w.shape[0] for w, _, _ in expect) == N_IMAGES
    rects = list(compose_fused.compose_samples(
        images, ks, rs, warper, corners, sizes, seam_masks, seam_corners,
        seam_ratio, compensator, g))
    assert [o for _, _, offs in expect for o in offs] == [
        o for _, _, o in rects]
    for (w0, wt0, off0), (w1, wt1, off1) in zip(expect, seen_t["k5"]):
        assert list(off0) == list(off1)
        np.testing.assert_array_equal(n(w0), n(w1))
        np.testing.assert_array_equal(n(wt0), n(wt1))


# Fast ingest on: full scale (raw 4:2:0 planes at num8 8, the Y plane as
# the work gray), and tests/test_pipeline_e2e.py's work_scale_snap case
# (work_megapix 0.3 x the capture, snapped up to work scale 6/8).
FAST = {"full scale": {},
        "work_scale_snap": dict(work_megapix=HW[0] * HW[1] / 1e6 * 0.3)}


@pytest.fixture(scope="module", params=sorted(FAST))
def both_fast(request, captures, tmp_path_factory):
    """Both stitch()es with fast ingest on, the port drawing its own RANSAC
    numbers from the reference's keys, recording the port's fast_prep."""
    d, rs = captures
    extra = FAST[request.param]
    run_j = tmp_path_factory.mktemp("run_jax_fast")
    run_t = tmp_path_factory.mktemp("run_torch_fast")
    cfg = dict(SMALL, fast_ingest=True, **extra)
    ref = jstitch(str(d), JConfig(checkpoint_dir=str(run_j), **cfg),
                  output="")
    rec = Recorder(stitcher, "fast_prep")
    with rec, checked_keys(JConfig().seed, 3) as drawn:
        got = stitch(str(d), StitchConfig(checkpoint_dir=str(run_t), **cfg),
                     output="", device="cpu")
    assert drawn[0] == 3
    return request.param, ref, got, rs, rec.calls["fast_prep"]


def test_fast_kept_indices_and_work_scale(both_fast):
    """The fast path ran (raw 4:2:0 route) and both keep every image at the
    same work scale: 1.0, or 0.75 where the snap applies."""
    name, ref, got, _, prep = both_fast
    (args, _, out), = prep
    assert isinstance(args[0], ingest.FastIngest) and args[0].raw_yuv
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))
    want_scale = 0.75 if name == "work_scale_snap" else 1.0
    assert got.work_scale == ref.work_scale == want_scale
    assert tuple(out[0].shape[1:]) == (round(HW[0] * want_scale),
                                       round(HW[1] * want_scale))


def test_fast_cameras_match_reference(both_fast):
    """Relative rotations within 0.05 degrees, focal rtol 1e-3, as for the
    default path; each within 0.8 degrees of the ground truth."""
    _, ref, got, rs, _ = both_fast
    cams = got.cameras.numpy()
    np.testing.assert_allclose(cams["focal"], np.asarray(ref.cameras.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.cameras.R)
    for a in range(N_IMAGES - 1):
        ang = rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                               rr[a + 1] @ rr[a].T)
        assert ang <= 0.05, (a, ang)
        assert rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                                rs[a + 1] @ rs[a].T) < 0.8


def test_fast_panorama_matches_reference(both_fast):
    """Shape within 2 px per axis; mean |difference| <= 2 on the common
    mask."""
    _, ref, got, _, _ = both_fast
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0


# Cylindrical warp, FEATHER blend, graph-cut colour seams, fast ingest on.
CYL = dict(SMALL, fast_ingest=True, warp_type="cylindrical",
           blend_type="feather", seam_find_type="gc_color")


@pytest.fixture(scope="module")
def both_cyl(captures, tmp_path_factory):
    """Both stitch()es of the CYL configuration, the port drawing its own
    RANSAC numbers from the reference's keys, recording each side's seam
    masks;
    then both resume from the reference's checkpoint
    (serialize_data=False)."""
    d, rs = captures
    run_j = tmp_path_factory.mktemp("run_jax_cyl")
    run_t = tmp_path_factory.mktemp("run_torch_cyl")
    recs = [Recorder(jseams, "find_seams"), Recorder(stitcher, "find_seams")]
    with recs[0]:
        ref = jstitch(str(d), JConfig(checkpoint_dir=str(run_j), **CYL),
                      output="")
    with recs[1], checked_keys(JConfig().seed, 3):
        got = stitch(str(d), StitchConfig(checkpoint_dir=str(run_t), **CYL),
                     output="", device="cpu")
    resume = dict(CYL, serialize_data=False, checkpoint_dir=str(run_j))
    rec = Recorder(stitcher, "start_fast_ingest")
    ref_resumed = jstitch(str(d), JConfig(**resume), output="")
    with rec:
        got_resumed = stitch(str(d), StitchConfig(**resume), output="",
                             device="cpu")
    return dict(ref=ref, got=got, rs=rs, seams_j=recs[0].calls["find_seams"],
                seams_t=recs[1].calls["find_seams"], run_j=run_j,
                ref_resumed=ref_resumed, got_resumed=got_resumed,
                ingest=rec.calls["start_fast_ingest"])


def _panoramas_close(ref, got):
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0


def test_cylindrical_feather_gc_matches_reference(both_cyl):
    """Equal kept indices; relative rotations within 0.05 degrees and focal
    rtol 1e-3; the graph-cut seam masks equal pixel for pixel; panorama
    shape within 2 px per axis and mean |difference| <= 2 on the common
    mask."""
    b = both_cyl
    ref, got = b["ref"], b["got"]
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))
    cams = got.cameras.numpy()
    np.testing.assert_allclose(cams["focal"], np.asarray(ref.cameras.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.cameras.R)
    for a in range(N_IMAGES - 1):
        assert rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                                rr[a + 1] @ rr[a].T) <= 0.05
    (_, _, mj), = b["seams_j"]
    (_, _, mt), = b["seams_t"]
    for a, m in zip(mj, mt):
        np.testing.assert_array_equal(np.asarray(m) > 0, np.asarray(a) > 0)
    assert sum(int((np.asarray(m) == 0).sum()) for m in mt) > 0
    _panoramas_close(ref, got)


def test_resumed_stitch_matches_reference(both_cyl):
    """serialize_data=False from the reference's checkpoint: no gray
    stream is asked of fast ingest; the kept indices are the file's;
    the cameras are the file's, equal to the reference's reading of it
    before wave correction, and the panorama matches the reference's
    resumed one and the stitch that wrote the checkpoint."""
    b = both_cyl
    ref_r, got_r = b["ref_resumed"], b["got_resumed"]
    (args, kwargs, _), = b["ingest"]
    assert kwargs["want_gray"] is False
    from image_stitching_tpu.core import persistence as jpersist
    assert got_r.kept_indices == ref_r.kept_indices == \
        jpersist.deserialize_indices(str(b["run_j"]))
    assert "Finding features" in got_r.stage_times
    assert "Pairwise matching" not in got_r.stage_times
    assert "Bundle adjustment" not in got_r.stage_times
    np.testing.assert_allclose(n(got_r.cameras.focal),
                               np.asarray(ref_r.cameras.focal), rtol=1e-6)
    rr = np.asarray(ref_r.cameras.R)
    cams = got_r.cameras.numpy()
    for a in range(N_IMAGES - 1):
        assert rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                                rr[a + 1] @ rr[a].T) <= 1e-3
    _panoramas_close(ref_r, got_r)
    _panoramas_close(b["ref"], got_r)
