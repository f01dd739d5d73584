"""Port parity of the stitch with the SIFT, SURF and AKAZE detectors: both
stitch()es on the same captures, the port drawing its own RANSAC numbers
from the reference's keys.

The captures are a 3-view ring of 240x320 (55 deg FOV, 0.55 overlap,
sigma-4 noise), where the JAX package keeps all three images with every
detector; at 160x224 its SIFT keeps too few keypoints a view and the
stitch stops with "Need more images" in both packages."""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_port import checked_keys, n, rel_rotation_deg
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.pipeline.stitcher import stitch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES = 3
SMALL = dict(num_features=400, compose_megapix=-1, seam_megapix=0.02,
             fast_ingest=False)
DETECTORS = ("sift", "surf", "akaze")


def _cfg(features, **kw):
    """The detector with the CLI's match_conf rule (0.65 for float
    descriptors, 0.32 for binary ones)."""
    conf = 0.65 if features in ("sift", "surf") else 0.32
    return dict(SMALL, features_type=features, match_conf=conf, **kw)


def _ring(directory, hw):
    images, k, rs = make_ring_captures(n_images=N_IMAGES, hw=hw, fov_deg=55,
                                       overlap_ratio=0.55)
    write_capture_dir(str(directory), images, k, rs)
    return rs


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("det_captures")
    return d, _ring(d, (240, 320))


@pytest.fixture(scope="module", params=DETECTORS)
def both(request, captures, tmp_path_factory):
    d, rs = captures
    feat = request.param
    run_j = tmp_path_factory.mktemp(f"run_jax_{feat}")
    run_t = tmp_path_factory.mktemp(f"run_torch_{feat}")
    ref = jstitch(str(d), JConfig(checkpoint_dir=str(run_j), **_cfg(feat)),
                  output="")
    with checked_keys(JConfig().seed, 3) as drawn:
        got = stitch(str(d), StitchConfig(checkpoint_dir=str(run_t),
                                          **_cfg(feat)),
                     output="", device="cpu")
    assert drawn[0] == 3
    return feat, ref, got, rs


def test_kept_indices_and_cameras(both):
    """Every image kept in both; relative rotations within 0.05 degrees
    and focal rtol 1e-3 (tests/test_torch_e2e.py's tolerance); the
    port's rotations within 0.8 degrees of the ground truth."""
    feat, ref, got, rs = both
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES)), \
        feat
    cams = got.cameras.numpy()
    np.testing.assert_allclose(cams["focal"], np.asarray(ref.cameras.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.cameras.R)
    for a in range(N_IMAGES - 1):
        ang = rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                               rr[a + 1] @ rr[a].T)
        assert ang <= 0.05, (feat, a, ang)
        assert rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                                rs[a + 1] @ rs[a].T) < 0.8, (feat, a)


def test_panorama_and_mask_match_reference(both):
    """The same canvas; masks equal but for at most 1e-4 of its pixels
    (edge pixels that the cameras' differences within the tolerance
    above move: one of 128240 with SIFT); mean |difference| <= 2 on the
    common mask."""
    feat, ref, got, _ = both
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    mj, mt = np.asarray(ref.mask), n(got.mask)
    assert pj.shape == pt.shape, feat
    assert (mt != mj).mean() <= 1e-4, (feat, int((mt != mj).sum()))
    common = mj & mt
    assert common.mean() > 0.9
    assert np.isfinite(pt).all()
    assert np.abs(pj - pt)[common].mean() <= 2.0, feat


def test_sift_small_captures_need_more_images(tmp_path):
    """At 160x224 SIFT drops all but one image in the reference; the port
    stops with the reference's message too."""
    d = tmp_path / "caps"
    d.mkdir()
    _ring(d, (160, 224))
    cfg = _cfg("sift", checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="Need more images"):
        jstitch(str(d), JConfig(**cfg), output="")
    with pytest.raises(RuntimeError, match="Need more images"):
        stitch(str(d), StitchConfig(**cfg), output="", device="cpu")


@pytest.mark.parametrize("feat", DETECTORS)
def test_python_dash_m_features(captures, tmp_path, feat):
    """`python -m image_stitching_tpu_torch <dir> --device cpu --features
    X` exits 0 and writes the panorama."""
    d, _ = captures
    out = str(tmp_path / "r.jpg")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "image_stitching_tpu_torch", str(d),
         "--device", "cpu", "--features", feat, "--result", out,
         "--checkpoint-dir", str(tmp_path), "--num-features", "400",
         "--compose-megapix", "-1", "--seam-megapix", "0.02"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"wrote {out}" in proc.stdout
    assert os.path.getsize(out) > 0
