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
    sx, _, _ = warps.backward_xy_1d(t(us), t(vs), t(k), t(r), scale)
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
    got = warps.backward_xy_1d(t(us), t(vs), t(k), t(r), 300.0)
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    ok = np.asarray(want[2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(a)[ok], np.asarray(b)[ok], rtol=1e-5,
                                   atol=1e-3)
    with pytest.raises(NotImplementedError):
        warps.make_warper("cylindrical", 1.0)
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
    w_got, m_got = tcf.warp_stack(t(imgs), t(ks), t(rs), 60.0, t(tls), ph,
                                  pw)
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
