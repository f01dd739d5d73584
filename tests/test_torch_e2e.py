"""Port parity of the whole slice: both stitch()es on the same captures.

The captures are tests/test_pipeline_e2e.py's (3 images of 160x224, ring
55 deg FOV, 0.55 overlap, sigma-4 noise), the configuration its small_cfg
plus the slice's options: no exposure compensation, the "no" seam
finder, the legacy uniform decode path."""

import os

import numpy as np
import pytest

import torch

from _torch_port import n, rel_rotation_deg
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.core import image_io
from image_stitching_tpu_torch.ops.warps import backward_xy_1d
from image_stitching_tpu_torch.pipeline import compose_fused
from image_stitching_tpu_torch.pipeline.stitcher import (compose_inputs,
                                                         stitch)

HW = (160, 224)
N_IMAGES = 3
SLICE = dict(num_features=400, compose_megapix=-1, seam_megapix=0.02,
             fast_ingest=False, expos_comp_type="no", seam_find_type="no")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("captures")
    images, k, rs = make_ring_captures(n_images=N_IMAGES, hw=HW, fov_deg=55,
                                       overlap_ratio=0.55)
    write_capture_dir(str(d), images, k, rs)
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
    comp = compose_inputs(got.cameras, HW, got.work_scale,
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
            sx, sy, _ = backward_xy_1d(us, vs, torch.as_tensor(comp.ks[i]),
                                       torch.as_tensor(comp.rs[i]),
                                       comp.warper.scale)
            expect.append((img.to(torch.float32), sx, sy))
    assert len(expect) == len(k2_calls) == N_IMAGES
    for want, seen in zip(expect, k2_calls):
        for a, b in zip(want, seen):
            np.testing.assert_array_equal(n(a), n(b))
