"""Port parity: spherical warps, ROIs, the seam-scale warp and kernel K2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from _torch_port import cuda_device, n, t
from image_stitching_tpu.kernels.warp_gather_pallas import (
    tile_spans_ok, warp_bilinear_pallas)
from image_stitching_tpu.ops import warps as jwarps
from image_stitching_tpu.pipeline import compose_fused as jcf
from image_stitching_tpu_torch.kernels.warp_gather import (
    warp_bilinear, warp_bilinear_plain)
from image_stitching_tpu_torch.ops import warps
from image_stitching_tpu_torch.pipeline import compose_fused as tcf


def _camera(seed, f=300.0, h=240, w=320):
    rng = np.random.default_rng(seed)
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    r = Rotation.from_euler("yxz", [rng.uniform(-np.pi, np.pi),
                                    rng.uniform(-1.2, 1.2),
                                    rng.uniform(-0.2, 0.2)]
                            ).as_matrix().astype(np.float32)
    return k, r


def _smooth_field(h, w, hc, wc, seed):
    """Smooth warp-like coordinates (tests/test_warp_pallas.py)."""
    rng = np.random.default_rng(seed)
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = (uu * (wc - 1) / max(w - 1, 1) * 0.9 + 3.0 +
          2.0 * np.sin(vv / 37.0) + rng.uniform(-0.4, 0.4, (h, w)))
    sy = (vv * (hc - 1) / max(h - 1, 1) * 0.9 + 2.0 +
          1.5 * np.cos(uu / 53.0) + rng.uniform(-0.4, 0.4, (h, w)))
    return sx.astype(np.float32), sy.astype(np.float32)


@pytest.mark.parametrize("hc,wc,h,w", [(48, 200, 40, 256), (96, 640, 64, 384)])
def test_k2_plain_vs_pallas_interpret(hc, wc, h, w):
    """In-range (clamped) coordinates, where the TPU kernel's clamp and
    BORDER_REFLECT agree: atol 1e-3 (the kernel's interp-matrix sums)."""
    img = np.random.default_rng(0).uniform(0, 255, (3, hc, wc)).astype(
        np.float32)
    sx, sy = _smooth_field(h, w, hc, wc, seed=1)
    sx = np.clip(sx, 0.0, wc - 1.0)
    sy = np.clip(sy, 0.0, hc - 1.0)
    assert tile_spans_ok(sx, sy, wc, hc)
    want = np.asarray(warp_bilinear_pallas(jnp.asarray(img), jnp.asarray(sx),
                                           jnp.asarray(sy), interpret=True))
    got = warp_bilinear_plain(t(img.transpose(1, 2, 0).copy()), t(sx), t(sy))
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-3)


def test_k2_plain_reflects_out_of_range_like_gather_sample():
    """Out-of-range coordinates: the reference's CPU compose sample
    (`_warp_gain_seam`'s gather_sample, BORDER_REFLECT) against the port's
    K2 path on the same warp; also the blend weights.  atol 1e-2 on 0-255:
    the backward maps differ by float32 ulps (fused multiply-adds)."""
    hc, wc = 60, 80
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (hc, wc, 3)).astype(np.float32)
    k = np.array([[70, 0, 40], [0, 70, 30], [0, 0, 1]], np.float32)
    r = np.eye(3, dtype=np.float32)
    scale = 70.0
    us = np.arange(-70, 70, dtype=np.float32)
    vs = np.arange(70, 150, dtype=np.float32)
    smask = np.zeros((96, 128), np.float32)
    smask[10:60, 20:110] = 1.0
    stl = np.array([-60.0, 90.0], np.float32)
    ref_w, ref_wt = jcf._warp_gain_seam(
        jnp.asarray(img), jnp.asarray(k), jnp.asarray(r), jnp.asarray(us),
        jnp.asarray(vs), jnp.float32(scale), jnp.asarray(smask),
        jnp.asarray(stl), jnp.float32(1.0), jnp.float32(1.0),
        jnp.ones(2), jnp.ones(4), proj_name="spherical", gain_mode="none")
    got_w, got_wt = tcf._warp_seam(t(img), t(k), t(r), t(us), t(vs), scale,
                                   t(smask), t(stl), 1.0)
    sx, _, _ = warps.backward_xy_1d("spherical", t(us), t(vs), t(k), t(r),
                                    scale)
    assert float((sx < 0).float().mean()) > 0.1   # many reflected taps
    np.testing.assert_allclose(n(got_w), np.asarray(ref_w), rtol=0,
                               atol=1e-2)
    assert (n(got_wt) == np.asarray(ref_wt)).mean() >= 0.999


def test_k2_plain_reflect_formula():
    """BORDER_REFLECT taps: -1 -> 0, -2 -> 1, n -> n - 1."""
    img = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    sx = np.array([[-1.0, -2.0, 3.0, 4.0, 1.5]], np.float32)
    sy = np.array([[0.0, 1.0, -1.0, 2.0, 0.5]], np.float32)
    got = n(warp_bilinear_plain(t(img), t(sx), t(sy)))
    want = np.stack([img[0, 0], img[1, 1], img[0, 2], img[1, 1],
                     0.25 * (img[0, 1] + img[0, 2] + img[1, 1] + img[1, 2])],
                    -1)
    np.testing.assert_allclose(got[:, 0], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_warp_roi_integer_equal(seed):
    k, r = _camera(seed)
    for scale in (300.0, 123.4):
        want = jwarps.make_warper("spherical", scale).warp_roi((240, 320), k,
                                                                r)
        got = warps.make_warper("spherical", scale).warp_roi((240, 320), k, r)
        assert got == want


def test_backward_map_and_unsupported_projection():
    k, r = _camera(1)
    us = np.linspace(-400, 400, 57, dtype=np.float32)
    vs = np.linspace(300, 700, 31, dtype=np.float32)
    want = jwarps.backward_xy_1d("spherical", jnp.asarray(us),
                                 jnp.asarray(vs), k, r, 300.0)
    got = warps.backward_xy_1d("spherical", t(us), t(vs), t(k), t(r), 300.0)
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    ok = np.asarray(want[2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(a)[ok], np.asarray(b)[ok], rtol=1e-5,
                                   atol=1e-3)
    with pytest.raises(ValueError, match="Can't create"):
        warps.make_warper("nope", 1.0)
    assert sorted(warps.PROJECTIONS) == sorted(jwarps.PROJECTIONS)
    for scale in (300.0, 123.4):
        assert warps.u_period("spherical", scale) == \
            jwarps.u_period("spherical", scale)
    assert warps.result_roi([(0, 5), (-3, 9)], [(10, 4), (6, 8)]) == \
        jwarps.result_roi([(0, 5), (-3, 9)], [(10, 4), (6, 8)])


def test_seam_scale_warp_stack():
    """`_warp_stack`: u8 pixels within +-1, masks equal on >= 99.9%."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, 48, 64, 3), np.uint8)
    ks = np.stack([_camera(s, f=60.0, h=48, w=64)[0] for s in (0, 1)])
    rs = np.stack([_camera(s, f=60.0, h=48, w=64)[1] for s in (0, 1)])
    warper = warps.make_warper("spherical", 60.0)
    rois = [warper.warp_roi((48, 64), ks[i], rs[i]) for i in range(2)]
    tls = np.asarray([[r_[0], r_[1]] for r_ in rois], np.float32)
    ph = -(-max(r_[3] for r_ in rois) // 64) * 64
    pw = -(-max(r_[2] for r_ in rois) // 64) * 64
    w_ref, m_ref = jcf._warp_stack(jnp.asarray(imgs), jnp.asarray(ks),
                                   jnp.asarray(rs), jnp.float32(60.0),
                                   jnp.asarray(tls), proj_name="spherical",
                                   pad_h=ph, pad_w=pw)
    w_got, m_got = tcf.warp_stack(t(imgs), t(ks), t(rs), 60.0, t(tls),
                                  "spherical", ph, pw)
    assert (n(m_got) == np.asarray(m_ref)).mean() >= 0.999
    diff = np.abs(n(w_got).astype(int) - np.asarray(w_ref).astype(int))
    assert diff.max() <= 1


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_cuda():
    dev = cuda_device()
    rng = np.random.default_rng(3)
    img = t(rng.uniform(0, 255, (50, 70, 3)).astype(np.float32)).to(dev)
    sx = t(rng.uniform(-90, 160, (64, 96)).astype(np.float32)).to(dev)
    sy = t(rng.uniform(-60, 110, (64, 96)).astype(np.float32)).to(dev)
    before = warp_bilinear.launches
    out = warp_bilinear(img, sx, sy)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before + 1
    np.testing.assert_array_equal(n(out), n(warp_bilinear_plain(img, sx, sy)))


# ---------------------------------------------------------------------------
# Every projection: ROIs, warp_point, backward maps, the affine split.
# ---------------------------------------------------------------------------

ALL_PROJ = sorted(jwarps.PROJECTIONS)
K_SMALL = np.array([[120.0, 0, 64], [0, 120, 48], [0, 0, 1]], np.float32)


def _cameras_for_roi():
    """Rotations by (yaw, pitch, roll): a few ordinary views, views that
    straddle azimuth +-pi (the date-line rebranch), and views with a pole
    inside the image (the spherical pole fix), as in tests/test_dateline.py
    and tests/test_warps.py."""
    eul = [(0.1, 0.3, 0.05), (0.0, 0.0, 0.0), (-0.4, 0.8, 0.2),
           (np.pi, 0.0, 0.0), (np.pi - 0.05, 0.2, 0.0), (-np.pi + 0.1, -0.1,
                                                         0.03),
           (0.3, np.pi / 2, 0.0), (0.0, -np.pi / 2, 0.0)]
    return [Rotation.from_euler("yxz", e).as_matrix().astype(np.float32)
            for e in eul]


@pytest.mark.parametrize("name", ALL_PROJ)
def test_warp_roi_and_point_all_projections(name):
    """Integer-equal ROIs and equal warp_point (the same float32 numpy
    table) at two scales, over ordinary, date-line and pole views."""
    for scale in (100.0, 37.5):
        jw = jwarps.make_warper(name, scale)
        tw = warps.make_warper(name, scale)
        for r in _cameras_for_roi():
            assert tw.warp_roi((96, 128), K_SMALL, r) == \
                jw.warp_roi((96, 128), K_SMALL, r), (name, scale)
            pts = np.float32([[10.0, 20.0], [64.0, 48.0], [127.0, 0.0]])
            for a, b in zip(tw.warp_point(pts, K_SMALL, r),
                            jw.warp_point(pts, K_SMALL, r)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dateline_rebranch_and_pole_fix_engage():
    """The cases above reach both special branches: a view at yaw pi gets a
    rebranched (narrow) cylindrical ROI, a straight-up view the spherical
    ROI extended to v = 0."""
    rots = _cameras_for_roi()
    w = warps.make_warper("cylindrical", 100.0)
    assert w.warp_roi((96, 128), K_SMALL, rots[3])[2] < np.pi * 100.0
    roi = warps.make_warper("spherical", 100.0).warp_roi((96, 128), K_SMALL,
                                                         rots[6])
    assert roi[1] <= 0 <= roi[1] + roi[3]


# Backward-map tolerances: torch and XLA evaluate the transcendentals to
# within a few float32 ulps of each other, and the maps divide by the
# ray depth, which magnifies them near the horizon of plane-like
# projections.  rtol 1e-5 / atol 1e-3 px, the spherical test's bound,
# holds for all 16 on these grids.
@pytest.mark.parametrize("name", ALL_PROJ)
def test_backward_maps_all_projections(name):
    k, r = K_SMALL, _cameras_for_roi()[0]
    jw = jwarps.make_warper(name, 100.0)
    x, y, w, h = jw.warp_roi((96, 128), k, r)
    us = (x + np.arange(w, dtype=np.float32)).astype(np.float32)
    vs = (y + np.arange(h, dtype=np.float32)).astype(np.float32)
    want = jwarps.backward_xy_1d(name, jnp.asarray(us), jnp.asarray(vs),
                                 jnp.asarray(k), jnp.asarray(r),
                                 jnp.float32(100.0))
    got = warps.backward_xy_1d(name, t(us), t(vs), t(k), t(r), 100.0)
    ok = np.asarray(want[2])
    np.testing.assert_array_equal(n(got[2]), ok)
    assert ok.mean() > 0.5
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(a)[ok], np.asarray(b)[ok], rtol=1e-5,
                                   atol=1e-3)


def test_affine_prep_split():
    """`_prep` for "affine": the linear part transposed and the scaled UV
    offset, equal to the reference's; every other projection passes K
    and R through."""
    h = np.array([[1.02, 0.05, 13.5], [-0.03, 0.98, -7.25], [0, 0, 1]],
                 np.float32)
    k_t, r_t, off_t = warps.make_warper("affine", 80.0)._prep(K_SMALL, h)
    k_j, r_j, off_j = jwarps.make_warper("affine", 80.0)._prep(K_SMALL, h)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(k_t, k_j)
    assert off_t == off_j and off_t != (0.0, 0.0)
    assert warps.make_warper("plane", 80.0)._prep(K_SMALL, h)[2] == \
        (0.0, 0.0)
    assert warps.result_roi_intersection([(-5, 2), (10, -3)],
                                         [(20, 10), (5, 30)]) == \
        jwarps.result_roi_intersection([(-5, 2), (10, -3)],
                                       [(20, 10), (5, 30)])


def test_k2_plain_out_of_int32_range_like_jax_gather():
    """Coordinates past +-2^31: a plane warp with K = R = I and scale 1
    maps the grid to itself, so the reference's compose sample
    (`_warp_gain_seam`, its CPU gather with int32 taps) and the port's
    (K2's plain version) gather at exactly the coordinates given; the
    samples are equal.  Then the tap conversion on NaN and infinities
    against XLA's float32 -> int32 conversion."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (13, 17, 3)).astype(np.float32)
    big = [-3e9, -2.2e9, -2147483904.0, -2147483648.0, -5.5, 0.25, 3.7,
           16.5, 2.1e9, 2147483520.0, 2147483648.0, 2.2e9, 3e9, 1e20, -1e20]
    us = np.asarray(big, np.float32)
    vs = np.asarray(big[::-1] + [7.5], np.float32)
    eye = np.eye(3, dtype=np.float32)
    smask = np.zeros((64, 64), np.float32)
    ref_w, _ = jcf._warp_gain_seam(
        jnp.asarray(img), jnp.asarray(eye), jnp.asarray(eye),
        jnp.asarray(us), jnp.asarray(vs), jnp.float32(1.0),
        jnp.asarray(smask), jnp.zeros(2), jnp.float32(1.0), jnp.float32(1.0),
        jnp.ones(2), jnp.ones(4), proj_name="plane", gain_mode="none")
    got_w, _ = tcf._warp_seam(t(img), t(eye), t(eye), t(us), t(vs), 1.0,
                              t(smask), torch.zeros(2), 1.0,
                              proj_name="plane")
    sx, sy, valid = warps.backward_xy_1d("plane", t(us), t(vs), t(eye),
                                         t(eye), 1.0)
    assert bool(valid.all())
    np.testing.assert_array_equal(n(sx)[0], us)
    np.testing.assert_array_equal(n(got_w), np.asarray(ref_w))
    from image_stitching_tpu_torch.kernels.warp_gather import int32_taps
    x = np.asarray(big + [np.nan, np.inf, -np.inf], np.float32)
    c0, c1 = int32_taps(torch.floor(t(x)))
    want0 = np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32))
    np.testing.assert_array_equal(n(c0), want0)
    np.testing.assert_array_equal(
        n(c1), np.asarray(jnp.asarray(want0) + 1))
