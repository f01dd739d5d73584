"""Port parity of the strip-streamed compose through `stitch()` on the
CPU: tests/test_torch_e2e.py's 3 x 160x224 ring with `compose_strips_mp`
below its canvas, so the stitch takes `fused_compose_strips` (4 strips of
128 columns), against the JAX package's stitch of the same captures and
configuration (the port drawing its own RANSAC numbers from the
reference's keys), and against the port's own whole-canvas stitch of the
same captures.
"""

import numpy as np
import pytest
import torch

from _torch_port import Recorder, checked_keys, n, rel_rotation_deg
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.pipeline import stitcher
from image_stitching_tpu_torch.pipeline.stitcher import stitch

N_IMAGES = 3
STRIPS = dict(num_features=400, compose_megapix=-1, seam_megapix=0.02,
              fast_ingest=False, compose_strips_mp=0.02, compose_strip_w=128)


@pytest.fixture(scope="module")
def strips(tmp_path_factory):
    d = tmp_path_factory.mktemp("captures")
    images, k, rs = make_ring_captures(n_images=N_IMAGES, hw=(160, 224),
                                       fov_deg=55, overlap_ratio=0.55)
    write_capture_dir(str(d), images, k, rs)
    runs = [tmp_path_factory.mktemp(f"run_{i}") for i in range(3)]
    ref = jstitch(str(d), JConfig(checkpoint_dir=str(runs[0]), **STRIPS),
                  output="")
    rec = Recorder(stitcher, "fused_compose", "fused_compose_strips")
    with rec, checked_keys(JConfig().seed, N_IMAGES) as drawn:
        got = stitch(str(d), StitchConfig(checkpoint_dir=str(runs[1]),
                                          **STRIPS),
                     output=str(runs[1] / "result.jpg"), device="cpu")
    assert drawn[0] == N_IMAGES
    whole_cfg = dict(STRIPS, compose_strips_mp=0.0)
    with checked_keys(JConfig().seed, N_IMAGES):
        whole = stitch(str(d), StitchConfig(checkpoint_dir=str(runs[2]),
                                            **whole_cfg),
                       output="", device="cpu")
    return ref, got, whole, rec.calls, runs[1]


def test_strip_dispatch(strips):
    """The canvas is above compose_strips_mp: the stitch took the strips
    (4 of 128 columns), not the whole-canvas compose, and its panorama,
    written as result.jpg, is a host tensor."""
    ref, got, _, calls, run = strips
    assert calls["fused_compose"] == []
    (args, kwargs, _), = calls["fused_compose_strips"]
    assert kwargs == {"strip_w": 128}
    h, w = got.mask.shape
    assert h * w / 1e6 >= STRIPS["compose_strips_mp"] and w > 3 * 128
    assert got.panorama.device.type == "cpu"
    assert got.panorama.dtype == torch.float32
    assert (run / "result.jpg").exists()
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))


def test_strips_match_whole_canvas_stitch(strips):
    """The same cameras composed whole: the mask equal, mean |diff| < 0.5
    and p99 <= 2 (tests/test_compose_strips.py's tolerance)."""
    _, got, whole, _, _ = strips
    mask = n(whole.mask)
    np.testing.assert_array_equal(n(got.mask), mask)
    diff = np.abs(n(got.panorama) - n(whole.panorama))[mask]
    assert float(diff.mean()) < 0.5, float(diff.mean())
    assert float(np.percentile(diff, 99)) <= 2.0


def test_strips_match_reference_stitch(strips):
    """Against the JAX stitch's strips: relative rotations within 0.05
    degrees, shape within 2 px per axis, mean |difference| <= 2 on the
    common mask (tests/test_torch_e2e.py's tolerance)."""
    ref, got, _, _, _ = strips
    cams = got.cameras.numpy()
    rr = np.asarray(ref.cameras.R)
    for a in range(N_IMAGES - 1):
        assert rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                                rr[a + 1] @ rr[a].T) <= 0.05
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0
