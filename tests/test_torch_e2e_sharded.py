"""Port parity of stitch() with the canvas sharded: both packages stitch
tests/test_pipeline_e2e.py's captures (3 images of 160x224) with
use_sharded_compose=True.  The JAX package shards over the conftest's 8
virtual CPU devices; the port's device list is replaced by 8 CPU shards
(`stitcher.local_devices`), so `compose_uniform` takes
`fused_compose_sharded` on a (1, 8) mesh.  The port draws its own RANSAC
numbers from the reference's keys.  Kept indices equal; the panorama
within the e2e tests' bounds (shape within 2 px per axis, common mask >
0.9, mean |diff| <= 2).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import Recorder, checked_keys, n
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.pipeline import stitcher

HW = (160, 224)
N_IMAGES = 3
CFG = dict(num_features=400, compose_megapix=-1, seam_megapix=0.02,
           fast_ingest=False, expos_comp_type="no", seam_find_type="no",
           use_sharded_compose=True)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    assert jax.device_count() == 8
    d = tmp_path_factory.mktemp("captures")
    images, k, rs = make_ring_captures(n_images=N_IMAGES, hw=HW, fov_deg=55,
                                       overlap_ratio=0.55)
    write_capture_dir(str(d), images, k, rs)
    run_j = tmp_path_factory.mktemp("run_jax")
    run_t = tmp_path_factory.mktemp("run_torch")
    ref = jstitch(str(d), JConfig(checkpoint_dir=str(run_j), **CFG),
                  output="")
    mp = pytest.MonkeyPatch()
    mp.setattr(stitcher, "local_devices",
               lambda kind: [torch.device("cpu")] * 8)
    rec = Recorder(stitcher, "fused_compose_sharded", "fused_compose")
    try:
        with rec, checked_keys(JConfig().seed, N_IMAGES):
            got = stitch_port(str(d), run_t)
    finally:
        mp.undo()
    return ref, got, rec


def stitch_port(source, run):
    return stitcher.stitch(source, StitchConfig(checkpoint_dir=str(run),
                                                **CFG),
                           output="", device="cpu")


def test_sharded_route_taken(both):
    _, got, rec = both
    assert rec.calls["fused_compose"] == []
    (args, _, _), = rec.calls["fused_compose_sharded"]
    assert args[0].shape == {"dp": 1, "sp": 8}
    assert got.panorama.device.type == "cpu"


def test_sharded_stitch_matches_reference(both):
    ref, got, _ = both
    assert got.kept_indices == ref.kept_indices == list(range(N_IMAGES))
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = np.asarray(ref.mask)[:h, :w] & n(got.mask)[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0
