"""Port parity of the loop compose as a whole: both stitch()es on a
mixed-size capture set, under the timelapse (CROP and AS_IS) and with the
auto-crop, the port drawing its own RANSAC numbers from the reference's
keys.

The mixed set is three ring views of 160x224, 192x256 and 160x224, each
with its own K at 55 deg, 0.6 overlap, sigma-4 noise; the uniform set is
tests/test_pipeline_e2e.py's (3 x 160x224, 0.55 overlap).  Gates as in
tests/test_torch_e2e.py: kept indices equal, relative rotations within
0.05 degrees, panoramas within 2 px per axis and mean |difference| <= 2
on the common mask."""

import contextlib
import os

import numpy as np
import pytest
from PIL import Image

from _torch_port import (Recorder, checked_keys, n, rel_rotation_deg,
                         write_mixed_ring)
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.ops import crop as jcrop
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.ops import blend, crop, warps
from image_stitching_tpu_torch.pipeline import stitcher
from image_stitching_tpu_torch.pipeline.stitcher import stitch

MIXED_HWS = [(160, 224), (192, 256), (160, 224)]
HW = (160, 224)
# Compose scale 0.75 (set by image 0), so each view is resized on its own
# before its compose warp.
SMALL = dict(num_features=400, compose_megapix=0.02, seam_megapix=0.02)


@contextlib.contextmanager
def _cwd(path):
    """Run the block in `path`: the timelapse writes its frames to the
    working directory."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _both(caps, cfg, tmp_path_factory, name, recorder=None):
    """The reference's and the port's stitch of `caps` under `cfg`, each
    in a working directory of its own."""
    run_j = tmp_path_factory.mktemp(f"{name}_jax")
    run_t = tmp_path_factory.mktemp(f"{name}_torch")
    with _cwd(run_j):
        ref = jstitch(caps, JConfig(**cfg), output="")
    with _cwd(run_t), checked_keys(JConfig().seed, 3), \
            (recorder or contextlib.nullcontext()):
        got = stitch(caps, StitchConfig(**cfg), output="", device="cpu")
    return ref, got, run_j, run_t


def _cameras_close(ref, got, n_images):
    assert got.kept_indices == ref.kept_indices == list(range(n_images))
    cams = got.cameras.numpy()
    np.testing.assert_allclose(cams["focal"], np.asarray(ref.cameras.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.cameras.R)
    for a in range(n_images - 1):
        assert rel_rotation_deg(cams["R"][a + 1] @ cams["R"][a].T,
                                rr[a + 1] @ rr[a].T) <= 0.05


def _panoramas_close(pj, pt, mj, mt):
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    common = mj[:h, :w] & mt[:h, :w]
    assert common.mean() > 0.9
    assert np.abs(pj[:h, :w] - pt[:h, :w])[common].mean() <= 2.0


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Both stitches of the mixed set under SMALL (fast ingest asked for:
    both take the legacy decode on mixed sizes), recording the port's
    warps (K2) and blender feeds (K5)."""
    caps = tmp_path_factory.mktemp("mixed_caps")
    _, rs = write_mixed_ring(str(caps), MIXED_HWS)
    rec = [Recorder(warps, "warp_bilinear"),
           Recorder(blend, "pyramid_accumulate"),
           Recorder(stitcher, "start_fast_ingest", "feed", "find_seams")]
    with contextlib.ExitStack() as stack:
        for r in rec:
            stack.enter_context(r)
        ref, got, _, _ = _both(str(caps), SMALL, tmp_path_factory, "mixed")
    return ref, got, rs, rec


def test_mixed_sizes_match_reference(mixed):
    """Kept 3/3; cameras and panorama as in tests/test_torch_e2e.py."""
    ref, got, _, _ = mixed
    _cameras_close(ref, got, len(MIXED_HWS))
    _panoramas_close(np.asarray(ref.panorama), n(got.panorama),
                     np.asarray(ref.mask), n(got.mask))
    assert got.panorama.dtype.is_floating_point
    assert float(got.panorama.min()) >= 0 and float(got.panorama.max()) <= 255


def test_mixed_sizes_take_the_loop(mixed):
    """The non-uniform branch: fast ingest declined the set; the host
    exposure feed and the seams ran on warped images of two sizes; every
    seam-scale and compose warp went through K2's wrapper (linear/reflect,
    one per image each), every blender feed through K5's (a bucket of one
    rect); the seams cut the overlaps and the gains are finite and
    positive."""
    _, got, _, rec = mixed
    (_, _, fast), = rec[2].calls["start_fast_ingest"]
    assert fast is None
    (args, _, comp), = rec[2].calls["feed"]
    shapes = {im.shape[:2] for im in args[1]}
    assert len(shapes) == 2
    assert np.all(np.isfinite(comp.gains)) and np.all(comp.gains > 0)
    (_, _, seam_masks), = rec[2].calls["find_seams"]
    assert sum(int((m == 0).sum()) for m in seam_masks) > 0
    k2 = rec[0].calls["warp_bilinear"]
    assert len(k2) == 2 * len(MIXED_HWS)
    for calls in (k2[:3], k2[3:]):     # the seam-scale, then the compose
        assert len({tuple(a[0].shape) for a, _, _ in calls}) == 2
    k5 = rec[1].calls["pyramid_accumulate"]
    assert len(k5) == len(MIXED_HWS)
    for (warped, weight, offs, accs, nb), _, _ in k5:
        assert warped.shape[0] == 1 and len(offs) == 1
        assert warped.shape[2] % (1 << nb) == 0
        assert warped.shape[3] % (1 << nb) == 0


@pytest.fixture(scope="module")
def uniform_caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("uniform_caps")
    images, k, rs = make_ring_captures(n_images=3, hw=HW, fov_deg=55,
                                       overlap_ratio=0.55)
    write_capture_dir(str(d), images, k, rs)
    return str(d)


@pytest.fixture(scope="module", params=["crop", "as_is"])
def timelapse(request, uniform_caps, tmp_path_factory):
    cfg = dict(SMALL, timelapse=True, timelapse_type=request.param)
    ref, got, run_j, run_t = _both(uniform_caps, cfg, tmp_path_factory,
                                   f"timelapse_{request.param}")
    return request.param, ref, got, run_j, run_t


def test_timelapse_matches_reference(timelapse):
    """The same frames, fixed_<name> in the working directory, each within
    mean |difference| 2 of the reference's; no result file; the
    panorama a 1x1 black placeholder, as the reference returns it."""
    kind, ref, got, run_j, run_t = timelapse
    _cameras_close(ref, got, 3)
    assert got.timelapse_frames == ref.timelapse_frames == [
        f"fixed_{i}.jpg" for i in range(3)]
    assert sorted(os.listdir(run_t)) == sorted(os.listdir(run_j))
    assert not os.path.exists(os.path.join(run_t, "result.jpg"))
    sizes = set()
    for name in got.timelapse_frames:
        with Image.open(os.path.join(run_j, name)) as a, \
                Image.open(os.path.join(run_t, name)) as b:
            fj = np.asarray(a, np.float32)
            ft = np.asarray(b, np.float32)
        assert fj.shape == ft.shape
        assert np.abs(fj - ft).mean() <= 2.0
        assert ft.max() > 0
        sizes.add(ft.shape)
    assert len(sizes) == 1
    assert tuple(got.panorama.shape) == (1, 1, 3)
    assert not bool(got.mask.any())


@pytest.fixture(scope="module")
def cropped(uniform_caps, tmp_path_factory):
    cfg = dict(SMALL, crop_result=True, fast_ingest=False)
    return _both(uniform_caps, cfg, tmp_path_factory, "crop")[:2]


def test_crop_result_matches_reference(cropped):
    """crop_result: the same cropped shape within 2 px, no black border
    rows or columns left, the mask the whole canvas (uncropped, as the
    reference returns it), the content within mean |difference| 2; and
    crop_rect bit-equal to the reference's on the reference's panorama
    padded by black."""
    ref, got = cropped
    _cameras_close(ref, got, 3)
    pj, pt = np.asarray(ref.panorama), n(got.panorama)
    assert abs(pj.shape[0] - pt.shape[0]) <= 2
    assert abs(pj.shape[1] - pt.shape[1]) <= 2
    assert tuple(got.mask.shape) == np.asarray(ref.mask).shape
    assert pt.shape[0] < got.mask.shape[0] or pt.shape[1] < got.mask.shape[1]
    h, w = min(pj.shape[0], pt.shape[0]), min(pj.shape[1], pt.shape[1])
    assert np.abs(pj[:h, :w] - pt[:h, :w]).mean() <= 2.0
    gray = pt.sum(-1) > 0
    assert gray[0].any() and gray[-1].any() and gray[:, 0].any() and \
        gray[:, -1].any()
    padded = np.pad(pj, [(5, 9), (13, 4), (0, 0)])
    assert crop.crop_rect(padded) == jcrop.crop_rect(padded)
