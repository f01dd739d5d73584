"""Port parity: exposure compensation (`feed_device`) of every type, the
gain map filter, and the compose's gain samples ("scalar", "channels",
"blocks" of one or three channels)."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import n, t
from image_stitching_tpu.config import ExposureCompensatorType as JECT
from image_stitching_tpu.ops import exposure as jexp
from image_stitching_tpu.pipeline import compose_fused as jcf
from image_stitching_tpu_torch.config import ExposureCompensatorType as ECT
from image_stitching_tpu_torch.ops import exposure
from image_stitching_tpu_torch.pipeline import compose_fused as tcf


def _stacks(seed, sizes, corners, hp, wp):
    """Padded u8 stacks with each image's rect at the origin, masks with a
    cut-out corner and a ragged edge (tests/test_ops.py's layout)."""
    rng = np.random.default_rng(seed)
    n_img = len(sizes)
    stack = np.zeros((n_img, hp, wp, 3), np.uint8)
    mstack = np.zeros((n_img, hp, wp), np.uint8)
    imgs, msks = [], []
    for i, (w, h) in enumerate(sizes):
        base = rng.integers(40, 200)
        img = np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(
            np.uint8)
        m = np.full((h, w), 255, np.uint8)
        m[:10, :20] = 0
        m[h - 7:, (i * 13) % w:] = 0
        stack[i, :h, :w] = img
        mstack[i, :h, :w] = m
        imgs.append(img.astype(np.float32))
        msks.append(m)
    return stack, mstack, imgs, msks


CASES = [
    # (sizes (w, h), corners, padded stack dims, u period)
    ([(240, 180), (250, 190), (240, 180), (260, 200)],
     [(0, 0), (120, 30), (260, 0), (350, 40)], 200, 260, None),
    # A ring that closes over the u period: the last pair couples
    # across the dateline through periodic_corner.
    ([(150, 100), (160, 110), (150, 100)],
     [(0, 5), (110, 0), (230, 8)], 128, 192, 340),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_feed_device_matches_reference(case):
    """Gains rtol 1e-5 against the JAX feed_device and the host feed
    (float32 one-hot sums of L2-norm intensities; the solve is float64 in
    all three), grid sizes equal."""
    sizes, corners, hp, wp, period = CASES[case]
    stack, mstack, imgs, msks = _stacks(case, sizes, corners, hp, wp)
    want = jexp.feed_device(corners, sizes, jnp.asarray(stack),
                            jnp.asarray(mstack), comp_type=JECT.GAIN_BLOCKS,
                            period=period)
    host = jexp.feed(corners, imgs, msks, comp_type=JECT.GAIN_BLOCKS,
                     period=period)
    got = exposure.feed_device(corners, sizes, t(stack), t(mstack),
                               comp_type=ECT.GAIN_BLOCKS, period=period)
    assert got.comp_type == ECT.GAIN_BLOCKS
    np.testing.assert_array_equal(got.grid_sizes, want.grid_sizes)
    np.testing.assert_array_equal(got.grid_sizes, host.grid_sizes)
    assert got.gains.shape == want.gains.shape
    np.testing.assert_allclose(got.gains, want.gains, rtol=1e-5)
    np.testing.assert_allclose(got.gains, host.gains, rtol=1e-5)
    assert np.abs(got.gains[got.gains > 0] - 1.0).max() > 1e-3


def test_feed_device_no_and_refusals():
    """NO gives unit gains; a name that is no compensator type raises."""
    stack = np.zeros((2, 8, 8, 3), np.uint8)
    masks = np.zeros((2, 8, 8), np.uint8)
    out = exposure.feed_device([(0, 0), (4, 0)], [(8, 8), (8, 8)], t(stack),
                               t(masks), comp_type="no")
    assert out.comp_type == ECT.NO and np.all(out.gains == 1)
    with pytest.raises(ValueError, match="gain_block"):
        exposure.feed_device([(0, 0), (4, 0)], [(8, 8), (8, 8)], t(stack),
                             t(masks), comp_type="gain_block")


@pytest.mark.parametrize("comp_type", ["gain", "channels",
                                       "channels_blocks"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_feed_device_other_types_match_reference(case, comp_type):
    """GAIN (L2-norm intensity, one block an image), CHANNELS (the system
    per channel) and CHANNELS_BLOCKS: gains rtol 1e-5 against the JAX
    feed_device and the host feed, shapes and grid sizes equal."""
    sizes, corners, hp, wp, period = CASES[case]
    stack, mstack, imgs, msks = _stacks(case, sizes, corners, hp, wp)
    want = jexp.feed_device(corners, sizes, jnp.asarray(stack),
                            jnp.asarray(mstack), comp_type=comp_type,
                            period=period)
    host = jexp.feed(corners, imgs, msks, comp_type=comp_type, period=period)
    got = exposure.feed_device(corners, sizes, t(stack), t(mstack),
                               comp_type=comp_type, period=period)
    assert got.comp_type == ECT(comp_type)
    np.testing.assert_array_equal(got.grid_sizes, want.grid_sizes)
    np.testing.assert_array_equal(got.grid_sizes, host.grid_sizes)
    assert got.gains.shape == want.gains.shape
    assert got.gains.dtype == np.asarray(want.gains).dtype
    np.testing.assert_allclose(got.gains, want.gains, rtol=1e-5)
    np.testing.assert_allclose(got.gains, host.gains, rtol=1e-5)
    assert np.abs(got.gains[got.gains > 0] - 1.0).max() > 1e-3


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 1, 1), (1, 4, 1),
                                   (6, 7, 1), (3, 9, 3)])
def test_filter_gain_map_equal(shape):
    g = np.random.default_rng(sum(shape)).uniform(0.5, 1.5, shape)
    for iters in (0, 1, 2, 3):
        np.testing.assert_array_equal(exposure._filter_gain_map(g, iters),
                                      jexp._filter_gain_map(g, iters))


def test_block_bookkeeping_equal():
    for w, h, b in ((240, 180, 64), (65, 64, 64), (1, 300, 32)):
        assert exposure._block_grid(w, h, b) == jexp._block_grid(w, h, b)
    for args in ((3, 70, 60, 62, 200), (0, 0, 64, 64, 130)):
        for x, y in zip(exposure._staircase(*args), jexp._staircase(*args)):
            np.testing.assert_array_equal(x, y)
        for blocks in (True, False):
            assert exposure._rank_cap(args[-1], 64, blocks) == \
                jexp._rank_cap(args[-1], 64, blocks)


def test_blocks_gain_sample_matches_reference():
    """The compose's GAIN_BLOCKS sample (`_warp_gain_seam`, gain_mode
    "blocks") on a rect that runs past the ROI on every side, with a gain
    map padded beyond the image's own grid.  On a constant-one image the
    warped output is the gain sample itself: atol 1e-4.  On a random image
    atol 1e-2 on 0-255, the K2 tolerance (the backward maps differ by
    float32 ulps)."""
    rng = np.random.default_rng(9)
    hc, wc = 60, 80
    k = np.array([[70, 0, 40], [0, 70, 30], [0, 0, 1]], np.float32)
    r = np.eye(3, dtype=np.float32)
    us = np.arange(-60, 60, dtype=np.float32)
    vs = np.arange(80, 140, dtype=np.float32)
    smask = np.zeros((96, 128), np.float32)
    smask[10:60, 20:110] = 1.0
    stl = np.array([-60.0, 90.0], np.float32)
    gain = np.zeros((5, 6), np.float32)
    gain[:4, :5] = rng.uniform(0.7, 1.3, (4, 5))
    grid = np.array([4.0, 5.0], np.float32)
    roi = np.array([-50.0, 85.0, 97.0, 48.0], np.float32)
    for img, atol in ((np.ones((hc, wc, 3), np.float32), 1e-4),
                      (rng.uniform(0, 255, (hc, wc, 3)).astype(np.float32),
                       1e-2)):
        ref_w, ref_wt = jcf._warp_gain_seam(
            jnp.asarray(img), jnp.asarray(k), jnp.asarray(r),
            jnp.asarray(us), jnp.asarray(vs), jnp.float32(70.0),
            jnp.asarray(smask), jnp.asarray(stl), jnp.float32(1.0),
            jnp.asarray(gain), jnp.asarray(grid), jnp.asarray(roi),
            proj_name="spherical", gain_mode="blocks")
        got_w, got_wt = tcf._warp_seam(t(img), t(k), t(r), t(us), t(vs),
                                       70.0, t(smask), t(stl), 1.0, t(gain),
                                       t(grid), t(roi))
        np.testing.assert_allclose(n(got_w), np.asarray(ref_w), rtol=0,
                                   atol=atol)
        assert (n(got_wt) == np.asarray(ref_wt)).mean() >= 0.999
    assert float(ref_w.min()) > 0.0 and np.ptp(np.asarray(ref_w)) > 10.0


def test_prep_gains():
    comp = exposure.ExposureCompensator(
        ECT.GAIN_BLOCKS, np.ones((2, 3, 4), np.float32),
        np.array([[3, 4], [2, 3]], np.int32))
    maps, grids, rois = tcf.prep_gains(comp, [(0, 1), (5, 6)],
                                       [(10, 20), (30, 40)], "cpu")
    _, jg, jgrid, jroi = jcf._prep_gains(
        jexp.ExposureCompensator(JECT.GAIN_BLOCKS, comp.gains,
                                 comp.grid_sizes), 2, [(0, 1), (5, 6)],
        [(10, 20), (30, 40)])
    for a, b in ((maps, jg), (grids, jgrid), (rois, jroi)):
        np.testing.assert_array_equal(n(a), b)
    assert tcf.prep_gains(None, [(0, 0)], [(1, 1)], "cpu") is None


# The compose's gain of each compensator type (`_warp_gain_seam` modes),
# as `_prep_gains` hands image i's row to it.
GAIN_MODES = {
    "gain": ("scalar", np.float32(1.17)),
    "channels": ("channels", np.array([0.83, 1.05, 1.21], np.float32)),
    "channels_blocks": ("blocks", None),
}


@pytest.mark.parametrize("comp_type", sorted(GAIN_MODES))
def test_other_gain_samples_match_reference(comp_type):
    """The compose sample with a GAIN scalar, a CHANNELS triple and a
    CHANNELS_BLOCKS map (padded beyond the image's own grid, on a rect
    that runs past the ROI on every side), within the blocks sample's
    tolerances: atol 1e-4 on a constant-one image, atol 1e-2 on 0-255 on a
    random one, weights equal at >= 99.9% of the pixels."""
    rng = np.random.default_rng(11)
    hc, wc = 60, 80
    k = np.array([[70, 0, 40], [0, 70, 30], [0, 0, 1]], np.float32)
    r = np.eye(3, dtype=np.float32)
    us = np.arange(-60, 60, dtype=np.float32)
    vs = np.arange(80, 140, dtype=np.float32)
    smask = np.zeros((96, 128), np.float32)
    smask[10:60, 20:110] = 1.0
    stl = np.array([-60.0, 90.0], np.float32)
    mode, gain = GAIN_MODES[comp_type]
    grid = np.ones(2, np.float32)
    if gain is None:
        gain = np.zeros((5, 6, 3), np.float32)
        gain[:4, :5] = rng.uniform(0.7, 1.3, (4, 5, 3))
        grid = np.array([4.0, 5.0], np.float32)
    roi = np.array([-50.0, 85.0, 97.0, 48.0], np.float32)
    for img, atol in ((np.ones((hc, wc, 3), np.float32), 1e-4),
                      (rng.uniform(0, 255, (hc, wc, 3)).astype(np.float32),
                       1e-2)):
        ref_w, ref_wt = jcf._warp_gain_seam(
            jnp.asarray(img), jnp.asarray(k), jnp.asarray(r),
            jnp.asarray(us), jnp.asarray(vs), jnp.float32(70.0),
            jnp.asarray(smask), jnp.asarray(stl), jnp.float32(1.0),
            jnp.asarray(gain), jnp.asarray(grid), jnp.asarray(roi),
            proj_name="spherical", gain_mode=mode)
        got_w, got_wt = tcf._warp_seam(t(img), t(k), t(r), t(us), t(vs),
                                       70.0, t(smask), t(stl), 1.0, t(gain),
                                       t(grid), t(roi))
        np.testing.assert_allclose(n(got_w), np.asarray(ref_w), rtol=0,
                                   atol=atol)
        assert (n(got_wt) == np.asarray(ref_wt)).mean() >= 0.999
    # The three channels carry different gains.
    assert np.ptp(np.asarray(ref_w).reshape(3, -1).mean(1)) > 1.0


@pytest.mark.parametrize("comp_type,shape", [
    (JECT.GAIN, (2,)), (JECT.CHANNELS, (2, 3)),
    (JECT.CHANNELS_BLOCKS, (2, 3, 4, 3))])
def test_prep_gains_other_types(comp_type, shape):
    """Each type's compose inputs equal the reference's `_prep_gains`, and
    image i's row has the rank that picks its gain mode."""
    gains = np.random.default_rng(2).uniform(0.8, 1.2, shape)
    grid_sizes = (np.array([[3, 4], [2, 3]], np.int32)
                  if len(shape) > 2 else np.ones((2, 2), np.int32))
    comp = exposure.ExposureCompensator(ECT(comp_type.value), gains,
                                        grid_sizes)
    got = tcf.prep_gains(comp, [(0, 1), (5, 6)], [(10, 20), (30, 40)], "cpu")
    mode, *want = jcf._prep_gains(
        jexp.ExposureCompensator(comp_type, gains, grid_sizes), 2,
        [(0, 1), (5, 6)], [(10, 20), (30, 40)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), b)
    assert mode == {0: "scalar", 1: "channels"}.get(got[0][0].ndim, "blocks")
