"""Port parity of the loop compose's modules: `Warper.warp`, the
blenders, the timelapser, the auto-crop, the host exposure `feed` and
`apply_gain`, and the seams of the non-uniform branch's fractional,
mixed-size warped images.  Inputs are made with numpy from fixed seeds;
each goes through the JAX package's function and the port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import n, t
from image_stitching_tpu.config import BlenderType as JBlend
from image_stitching_tpu.config import ExposureCompensatorType as JEC
from image_stitching_tpu.config import TimelapserType as JTL
from image_stitching_tpu.ops import blend as jblend
from image_stitching_tpu.ops import crop as jcrop
from image_stitching_tpu.ops import exposure as jexposure
from image_stitching_tpu.ops import seams as jseams
from image_stitching_tpu.ops import timelapse as jtimelapse
from image_stitching_tpu.ops import warps as jwarps
from image_stitching_tpu.ops.imgproc import resize as jresize
from image_stitching_tpu_torch.config import BlenderType, TimelapserType
from image_stitching_tpu_torch.config import ExposureCompensatorType as ECType
from image_stitching_tpu_torch.data.synth import ring_geometry, render_view
from image_stitching_tpu_torch.ops import blend, crop, exposure, seams
from image_stitching_tpu_torch.ops import timelapse, warps

# Warper.warp: (interp, border) modes and projections.
MODES = [("linear", "reflect"), ("nearest", "constant"),
         ("linear", "constant")]
PROJECTIONS = ["spherical", "cylindrical", "plane"]


def _camera(h: int, w: int, yaw: float, pitch: float, scale_f: float):
    f = w / 2.0 / np.tan(np.radians(27.5)) * scale_f
    k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return k, (ry @ rx).astype(np.float32), f


# The maps' float32 rounding: both packages evaluate the same formulas,
# but their transcendentals and XLA's fusion round differently, by a few
# ulp of coordinates below 100 px.
MAP_EPS = 2e-5


@pytest.mark.parametrize("proj", PROJECTIONS)
@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
def test_warper_warp_matches_reference(proj, mode):
    """Warper.warp on the detected ROI and on an ROI wider than it (rays
    behind the camera on the plane): the backward maps within MAP_EPS px
    of the reference's, validity equal; nearest bit-equal (the 2-D mask
    too); the linear modes on every pixel within 1e-3 plus what a MAP_EPS
    shift of the map can move a bilinear sample (twice the largest
    neighbour step of the source), and within 1e-3 on average."""
    interp, border = mode
    rng = np.random.default_rng(3)
    h, w = 44, 60
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    mask = np.full((h, w), 255, np.uint8)
    k, r, f = _camera(h, w, 0.3, -0.1, 1.0)
    jw = jwarps.make_warper(proj, f)
    tw = warps.make_warper(proj, f)
    roi = jw.warp_roi((h, w), k, r)
    assert tw.warp_roi((h, w), k, r) == roi
    wide = (roi[0] - 9, roi[1] - 7, roi[2] + 20, roi[3] + 13)
    step = float(max(np.abs(np.diff(img.astype(np.float32), axis=a)).max()
                     for a in (0, 1)))
    for dst in (None, wide):
        x, y, dw, dh = dst or roi
        us = x + np.arange(dw, dtype=np.float32)
        vs = y + np.arange(dh, dtype=np.float32)
        mj = jwarps.backward_xy_1d(proj, jnp.asarray(us), jnp.asarray(vs),
                                   jnp.asarray(k), jnp.asarray(r),
                                   jnp.float32(f))
        mt = warps.camera_backward_xy(proj, t(us), t(vs), t(k), t(r), f)
        np.testing.assert_array_equal(n(mt[2]), np.asarray(mj[2]))
        for a, b in zip(mj[:2], mt[:2]):
            np.testing.assert_allclose(n(b), np.asarray(a), rtol=0,
                                       atol=MAP_EPS)
        cj, oj = jw.warp(jnp.asarray(img), k, r, interp=interp,
                         border=border, dst_roi=dst)
        ct, ot = tw.warp(t(img), k, r, interp=interp, border=border,
                         dst_roi=dst)
        assert tuple(ct) == tuple(cj)
        assert ot.dtype == torch.float32 and ot.shape == oj.shape
        diff = np.abs(n(ot) - np.asarray(oj))
        if interp == "nearest":
            np.testing.assert_array_equal(n(ot), np.asarray(oj))
        else:
            assert diff.max() <= 1e-3 + 2 * step * MAP_EPS, diff.max()
            assert diff.mean() <= 1e-3, diff.mean()
        _, mask_j = jw.warp(jnp.asarray(mask), k, r, interp="nearest",
                            border=border, dst_roi=dst)
        _, mask_t = tw.warp(t(mask), k, r, interp="nearest", border=border,
                            dst_roi=dst)
        np.testing.assert_array_equal(n(mask_t), np.asarray(mask_j))
    if border == "constant":
        assert 0 < float((n(mask_t) > 0).mean()) < 1


# Three overlapping rects on one canvas; the third (12 px wide) is
# narrower than the multiband gap 3 * 2^3, so its reflect pad folds more
# than once.
RECTS = [((0, 0), (80, 60)), ((50, 10), (70, 64)), ((104, -5), (12, 50))]


@pytest.fixture(scope="module")
def feeds():
    """(image (h, w, 3) float32 0-255, fractional; mask (h, w) bool,
    an ellipse with a hole; corner) of each rect."""
    rng = np.random.default_rng(11)
    out = []
    for (x, y), (w, h) in RECTS:
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        ell = ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
        mask = (ell <= 1.05) & ~((np.abs(yy - h // 3) < 2) &
                                 (np.abs(xx - w // 2) < 2))
        out.append((img, mask, (x, y)))
    return out


BLENDERS = ["multiband", "feather", "no"]


@pytest.mark.parametrize("kind", BLENDERS)
def test_blenders_match_reference(feeds, kind):
    """MultiBandBlender (3 bands), FeatherBlender (sharpness 1/6) and
    NoBlender fed the same three rects: the blended panorama within 1e-3
    on 0-255, the masks equal."""
    corners = [c for c, _ in RECTS]
    sizes = [s for _, s in RECTS]
    if kind == "multiband":
        jb = jblend.MultiBandBlender(corners, sizes, num_bands=3)
        tb = blend.MultiBandBlender(corners, sizes, num_bands=3, device="cpu")
        assert tb.rect(corners[2], 50, 12)[2] - tb.rect(
            corners[2], 50, 12)[0] > 12 + 2 * 12
    elif kind == "feather":
        jb = jblend.FeatherBlender(corners, sizes, sharpness=1.0 / 6)
        tb = blend.FeatherBlender(corners, sizes, sharpness=1.0 / 6,
                                  device="cpu")
    else:
        jb = jblend.NoBlender(corners, sizes)
        tb = blend.NoBlender(corners, sizes, device="cpu")
    for img, mask, corner in feeds:
        jb.feed(jnp.asarray(img), jnp.asarray(mask), corner)
        tb.feed(t(img), t(mask), corner)
    pj, mj = jb.blend()
    pt, mt = tb.blend()
    assert pt.shape == pj.shape
    np.testing.assert_array_equal(n(mt), np.asarray(mj))
    np.testing.assert_allclose(n(pt), np.asarray(pj), atol=1e-3)
    assert float(n(mt).mean()) > 0.5


def test_make_blender_and_pyramids_match_reference(feeds):
    """make_blender picks the same blender and band count; pyr_down and
    pyr_up on HWC and HW within 1e-4 of the reference's."""
    corners = [c for c, _ in RECTS]
    sizes = [s for _, s in RECTS]
    for bt, strength in ((JBlend.MULTI_BAND, 5.0), (JBlend.FEATHER, 5.0),
                         (JBlend.NO, 5.0), (JBlend.MULTI_BAND, 0.5)):
        jb = jblend.make_blender(corners, sizes, bt, strength)
        tb = blend.make_blender(corners, sizes, BlenderType(bt.value),
                                strength, device="cpu")
        assert type(tb).__name__ == type(jb).__name__
        if isinstance(jb, jblend.MultiBandBlender):
            assert tb.num_bands == jb.num_bands and tb.roi == jb.roi
        if isinstance(jb, jblend.FeatherBlender):
            assert tb.sharpness == pytest.approx(jb.sharpness)
    img = feeds[1][0]
    for x in (img, img[..., 0]):
        down = blend.pyr_down(t(x))
        np.testing.assert_allclose(n(down), np.asarray(jblend.pyr_down(
            jnp.asarray(x))), atol=1e-4)
        out_hw = (x.shape[0], x.shape[1])
        np.testing.assert_allclose(
            n(blend.pyr_up(down, out_hw)),
            np.asarray(jblend.pyr_up(jnp.asarray(n(down)), out_hw)),
            atol=1e-4)


# Timelapse ROIs: overlapping rects, and a full ring's worth of rects
# whose intersection is empty.
TL_SCENES = {"overlapping": RECTS[:2] + [((30, 5), (60, 50))],
             "empty intersection": RECTS}


@pytest.mark.parametrize("kind", ["crop", "as_is"])
@pytest.mark.parametrize("scene", sorted(TL_SCENES))
def test_timelapser_matches_reference(feeds, kind, scene):
    """Timelapser CROP and AS_IS: the same ROI and each frame's canvas
    equal, including the 1x1 canvas of an empty intersection."""
    corners = [c for c, _ in TL_SCENES[scene]]
    sizes = [s for _, s in TL_SCENES[scene]]
    jt = jtimelapse.Timelapser(corners, sizes, JTL(kind))
    tt = timelapse.Timelapser(corners, sizes, TimelapserType(kind),
                              device="cpu")
    assert tt.roi == jt.roi
    rng = np.random.default_rng(4)
    for corner, (w, h) in zip(corners, sizes):
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        fj = jt.process(jnp.asarray(img), None, corner)
        ft = tt.process(t(img), None, corner)
        np.testing.assert_array_equal(n(ft), np.asarray(fj))
    if scene == "empty intersection" and kind == "crop":
        assert tt.roi[2] <= 0
        assert tuple(tt.get_dst().shape) == (max(tt.roi[3], 1), 1, 3)
    assert timelapse.fixed_name("/a/b/3.jpg") == \
        jtimelapse.fixed_name("/a/b/3.jpg") == "fixed_3.jpg"


def test_crop_rect_matches_reference():
    """crop_rect bit-equal on the JAX package's crop test panoramas
    (tests/test_ops.py): a padded random interior and a slanted band; and
    check_interior_exterior on both."""
    rng = np.random.default_rng(0)
    inner = rng.uniform(10, 255, (40, 60, 3)).astype(np.float32)
    padded = np.pad(inner, [(7, 9), (11, 13), (0, 0)])
    slanted = np.zeros((60, 100, 3), np.float32)
    for y in range(10, 50):
        x0 = 5 + (y - 10) // 4
        slanted[y, x0:x0 + 70] = 128.0
    for img in (padded, slanted, slanted[..., 0], np.zeros((5, 6, 3))):
        rect = crop.crop_rect(img)
        assert rect == jcrop.crop_rect(img)
        np.testing.assert_array_equal(crop.crop(img), jcrop.crop(img))
        mask = (img.reshape(img.shape[0], img.shape[1], -1).sum(-1) > 0
                ).astype(np.uint8) * 255
        assert crop.check_interior_exterior(mask, rect) == \
            jcrop.check_interior_exterior(mask, rect)


# The non-uniform branch's seam-scale inputs: three ring views of two
# sizes at their own K, resized fractionally and warped spherically.
SEAM_HWS = [(40, 56), (48, 64), (40, 56)]


@pytest.fixture(scope="module")
def warped_mixed():
    """(corners, fractional warped images (h_i, w_i, 3) float32, masks
    (h_i, w_i) u8) of SEAM_HWS's views, each rendered at twice its size
    and resized, then warped by the JAX package's Warper.warp."""
    warper = jwarps.make_warper("spherical", 56 / 2 / np.tan(np.radians(
        27.5)))
    corners, images, masks = [], [], []
    for i, (h, w) in enumerate(SEAM_HWS):
        k, rs = ring_geometry(3, (h, w), 55.0, 0.45)
        k32 = k.astype(np.float32)
        r32 = rs[i].astype(np.float32)
        full = render_view(np.diag([2.0, 2.0, 1.0]) @ k, rs[i],
                           (2 * h, 2 * w))
        src = np.asarray(jresize(jnp.asarray(full), (h, w)))
        assert np.any(np.mod(src, 1.0))
        roi = warper.warp_roi((h, w), k32, r32)
        c, img = warper.warp(jnp.asarray(src), k32, r32, dst_roi=roi)
        _, m = warper.warp(jnp.asarray(np.full((h, w), 255, np.uint8)),
                           k32, r32, interp="nearest", border="constant",
                           dst_roi=roi)
        corners.append(c)
        images.append(np.asarray(img))
        masks.append(np.asarray(m).astype(np.uint8))
    return corners, images, masks


def _stack(images):
    """The port's padded device stack of the images, each at the origin."""
    hp = max(im.shape[0] for im in images)
    wp = max(im.shape[1] for im in images)
    out = torch.zeros((len(images), hp, wp, 3))
    for i, im in enumerate(images):
        out[i, :im.shape[0], :im.shape[1]] = t(im)
    return out


@pytest.mark.parametrize("content", ["warped", "flat"])
@pytest.mark.parametrize("seam_type", ["dp_color", "dp_colorgrad",
                                       "gc_color"])
def test_mixed_size_seams_match_reference_host_route(warped_mixed, content,
                                                     seam_type):
    """find_seams on the fractional mixed-size warped images, from the
    port's padded stack, bit-equal to the reference's host route
    (images_dev=None, float32 DP); also on flat content (every overlap
    pixel costs the same, so the DPs decide by their argmin ties)."""
    corners, images, masks = warped_mixed
    if content == "flat":
        images = [np.full_like(im, 100.25) for im in images]
    want = jseams.find_seams(images, corners, masks, seam_type)
    got = seams.find_seams(corners, masks, seam_type,
                           images_dev=_stack(images))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert sum(int(((m > 0) & (g == 0)).sum())
               for m, g in zip(masks, got)) > 0


GAIN_TYPES = ["gain", "gain_blocks", "channels", "channels_blocks"]


@pytest.mark.parametrize("comp_type", GAIN_TYPES)
def test_host_feed_and_apply_gain_match_reference(warped_mixed, comp_type):
    """The host feed's gains within rtol 1e-6 of the reference's on the
    mixed-size warped images (block size 16, so each image has its own
    grid; the ring's u period couples nothing here), grid sizes equal;
    apply_gain on a compose-scale image twice each warped image's size
    within 1e-4."""
    corners, images, masks = warped_mixed
    # Brighten the middle view so the gains move off 1.
    images = [im * (1.3 if i == 1 else 1.0) for i, im in enumerate(images)]
    kw = dict(nr_feeds=1, nr_filtering=2, block_size=16)
    cj = jexposure.feed(corners, images, masks, comp_type=JEC(comp_type),
                        **kw)
    ct = exposure.feed(corners, images, masks, comp_type=ECType(comp_type),
                       **kw)
    np.testing.assert_array_equal(ct.grid_sizes, np.asarray(cj.grid_sizes))
    np.testing.assert_allclose(ct.gains, np.asarray(cj.gains), rtol=1e-6)
    assert np.abs(np.asarray(ct.gains) - 1).max() > 1e-3
    rng = np.random.default_rng(2)
    for i, im in enumerate(images):
        big = rng.uniform(0, 255, (2 * im.shape[0] + 1, 2 * im.shape[1],
                                   3)).astype(np.float32)
        want = jexposure.apply_gain(cj, i, (0, 0), jnp.asarray(big))
        got = exposure.apply_gain(ct, i, t(big))
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


def test_host_feed_no_compensation():
    """NO: unit gains and unit grids, as the reference; apply_gain leaves
    the image as it is."""
    imgs = [np.ones((4, 5, 3), np.float32)] * 2
    masks = [np.full((4, 5), 255, np.uint8)] * 2
    ct = exposure.feed([(0, 0), (2, 0)], imgs, masks, comp_type="no")
    cj = jexposure.feed([(0, 0), (2, 0)], imgs, masks, comp_type="no")
    np.testing.assert_array_equal(ct.gains, np.asarray(cj.gains))
    np.testing.assert_array_equal(ct.grid_sizes, np.asarray(cj.grid_sizes))
    x = t(imgs[0])
    assert torch.equal(exposure.apply_gain(ct, 0, x), x)
