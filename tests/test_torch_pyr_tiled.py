"""Port parity of the pyramid above the 4096-px dense threshold: the port's
banded `pyr_down_mm` / `pyr_up_mm` against the JAX package's tiled
einsums and against the port's own dense matrices, on
tests/test_pyr_tiled.py's shapes, with both parities of the output size
(rtol 1e-5, atol 1e-4); and no matrix is built for an axis above the
threshold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import n, t
from image_stitching_tpu.ops import pyr_mat as jpm
from image_stitching_tpu_torch.ops import pyr_mat as pm

TOL = dict(rtol=1e-5, atol=1e-4)


def _dense_down(x):
    return (torch.as_tensor(pm._down_mat_np(x.shape[-2])) @ x
            @ torch.as_tensor(pm._down_mat_np(x.shape[-1])).t())


def _dense_up(x, out_hw):
    return (torch.as_tensor(pm._up_mat_np(out_hw[0], x.shape[-2])) @ x
            @ torch.as_tensor(pm._up_mat_np(out_hw[1], x.shape[-1])).t())


def test_threshold_is_the_reference_s():
    assert pm._T_DENSE == jpm._T_DENSE == 4096


@pytest.mark.parametrize("shape", [(2, 129, 4201), (2, 130, 4202),
                                   (3, 4201, 33)])
def test_banded_down(shape):
    x = np.random.default_rng(0).uniform(-5, 5, shape).astype(np.float32)
    got = pm.pyr_down_mm(t(x))
    want = np.asarray(jpm.pyr_down_mm(jnp.asarray(x)))
    assert tuple(got.shape) == want.shape == (
        shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2)
    np.testing.assert_allclose(n(got), want, **TOL)
    np.testing.assert_allclose(n(got), n(_dense_down(t(x))), **TOL)


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 65, 2101), (129, 4201)), ((2, 65, 2101), (130, 4202)),
    ((3, 2101, 17), (4201, 33)), ((3, 2101, 17), (4202, 34))])
def test_banded_up(shape, out_hw):
    x = np.random.default_rng(1).uniform(-5, 5, shape).astype(np.float32)
    got = pm.pyr_up_mm(t(x), out_hw)
    want = np.asarray(jpm.pyr_up_mm(jnp.asarray(x), out_hw))
    assert tuple(got.shape) == want.shape == (shape[0],) + out_hw
    np.testing.assert_allclose(n(got), want, **TOL)
    np.testing.assert_allclose(n(got), n(_dense_up(t(x), out_hw)), **TOL)


def test_both_axes_large_builds_no_dense_matrix():
    """(4224, 4352) down and up, both axes above the threshold: equal to
    the JAX tiled path, and no matrix of the port's cache has an axis
    above 4096."""
    pm._on_device.cache_clear()
    x = np.random.default_rng(2).uniform(0, 255, (4224, 4352)).astype(
        np.float32)
    d = pm.pyr_down_mm(t(x))
    np.testing.assert_allclose(n(d), np.asarray(jpm.pyr_down_mm(
        jnp.asarray(x))), **TOL)
    assert tuple(d.shape) == (2112, 2176)
    u = pm.pyr_up_mm(d, (4224, 4352))
    np.testing.assert_allclose(n(u), np.asarray(jpm.pyr_up_mm(
        jnp.asarray(n(d)), (4224, 4352))), **TOL)
    assert pm._on_device.cache_info().currsize == 0
    pm.pyr_down_mm(t(x[:, :4000]))
    info = pm._on_device.cache_info()
    assert info.currsize == 1          # the 4000-px axis only
    with pytest.raises(ValueError, match="not a pyrUp"):
        pm.pyr_up_mm(d, (4224, 4000 * 2 + 1))


@pytest.mark.parametrize("shape", [(3, 129, 301), (4, 130, 4096)])
def test_dense_sizes_keep_the_matrix_order(shape):
    """Up to the threshold each axis is its dense matrix, rows first: the
    result is bit-equal to D_h @ x @ D_w^T and U_h @ x @ U_w^T."""
    x = t(np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32))
    dh, dw = pm.down_mats(shape[1], shape[2], device="cpu")
    d = pm.pyr_down_mm(x)
    assert torch.equal(d, dh @ x @ dw.t())
    uh, uw = pm.up_mats(shape[1], shape[2], d.shape[1], d.shape[2],
                        device="cpu")
    assert torch.equal(pm.pyr_up_mm(d, shape[1:]), uh @ d @ uw.t())
