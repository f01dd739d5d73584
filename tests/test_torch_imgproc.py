"""Port parity: ops/imgproc.py (resize, gray, blur, dilate) and pyramids."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import n, t
from image_stitching_tpu.ops import imgproc as jref
from image_stitching_tpu.ops import pyr_mat as jpyr
from image_stitching_tpu_torch.ops import imgproc, pyr_mat

# atol 1e-4 on the 0-255 scale: a few float32 ulps at 255 (1.5e-5 each).
# resize, gray and blur round like the reference's fused multiply-adds,
# so they are bit-equal in practice; the tolerance leaves room for the
# rare float64 double rounding of the emulated FMA.
ATOL = 1e-4


@pytest.mark.parametrize("shape,out_hw", [
    ((160, 224), (133, 187)), ((160, 224, 3), (92, 130)),
    ((96, 128, 3), (192, 256)), ((61, 83), (61, 83))])
def test_resize(shape, out_hw):
    img = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jref.resize(jnp.asarray(img), out_hw))
    got = n(imgproc.resize(t(img), out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resize_uint8_input():
    img = np.random.default_rng(1).integers(0, 256, (50, 70, 3), np.uint8)
    want = np.asarray(jref.resize(jnp.asarray(img), (33, 47)))
    np.testing.assert_allclose(n(imgproc.resize(t(img), (33, 47))), want,
                               rtol=0, atol=ATOL)


def test_rgb_to_gray_and_blur():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (70, 90, 3)).astype(np.float32)
    np.testing.assert_allclose(n(imgproc.rgb_to_gray(t(img))),
                               np.asarray(jref.rgb_to_gray(jnp.asarray(img))),
                               rtol=0, atol=ATOL)
    g = img[..., 0]
    np.testing.assert_allclose(
        n(imgproc.gaussian_blur(t(g), 2.0, 3)),
        np.asarray(jref.gaussian_blur(jnp.asarray(g), 2.0, 3)),
        rtol=0, atol=ATOL)


def test_dilate3_and_scale_size():
    m = (np.random.default_rng(3).random((4, 33, 41)) > 0.93).astype(
        np.float32)
    np.testing.assert_array_equal(n(imgproc.dilate3(t(m))),
                                  np.asarray(jref.dilate3(jnp.asarray(m))))
    for h, w, s in ((2448, 3264, 0.5), (160, 224, 0.3), (7, 9, 0.01)):
        assert imgproc.scale_size(h, w, s) == jref.scale_size(h, w, s)


@pytest.mark.parametrize("h,w", [(64, 96), (37, 53)])
def test_pyramid_matrices_and_ops(h, w):
    """Dense pyrDown/pyrUp matrices equal the reference's; the products
    agree to float32 summation order (atol 1e-3 on 0-255 values)."""
    dh, dw = pyr_mat.down_mats(h, w, device="cpu")
    rdh, rdw = jpyr.down_mats(h, w)
    np.testing.assert_array_equal(n(dh), np.asarray(rdh))
    np.testing.assert_array_equal(n(dw), np.asarray(rdw))
    x = np.random.default_rng(4).uniform(0, 255, (4, h, w)).astype(
        np.float32)
    down = n(pyr_mat.pyr_down_mm(t(x)))
    np.testing.assert_allclose(down, np.asarray(jpyr.pyr_down_mm(
        jnp.asarray(x))), rtol=0, atol=1e-3)
    up = n(pyr_mat.pyr_up_mm(t(down), (h, w)))
    np.testing.assert_allclose(up, np.asarray(jpyr.pyr_up_mm(
        jnp.asarray(down), (h, w))), rtol=0, atol=1e-3)
