"""Port parity: DP colour seams (`find_seams` "dp_color" / "dp_colorgrad")
on the device-sourced route, from the same padded u8 warped stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import n, t
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.ops import seams as jseams
from image_stitching_tpu.ops import warps as jwarps
from image_stitching_tpu.pipeline import compose_fused as jcf
from image_stitching_tpu_torch.ops import seams


@pytest.fixture(scope="module")
def ring_stack():
    """A seeded 3-image ring warped at seam scale by the reference's
    `_warp_stack`: the padded u8 stack, the masks cut to each ROI, the
    corners and the u period."""
    images, k, rs = make_ring_captures(n_images=3, hw=(96, 128), fov_deg=55,
                                       overlap_ratio=0.55)
    imgs = np.stack(images).astype(np.uint8)
    ks = np.repeat(k[None], 3, 0).astype(np.float32)
    rs = np.asarray(rs, np.float32)
    warper = jwarps.make_warper("spherical", float(k[0, 0]))
    rois = [warper.warp_roi((96, 128), ks[i], rs[i]) for i in range(3)]
    stack, masks = jcf._warp_stack(
        jnp.asarray(imgs), jnp.asarray(ks), jnp.asarray(rs),
        jnp.float32(warper.scale),
        jnp.asarray(np.asarray([r[:2] for r in rois], np.float32)),
        proj_name="spherical",
        pad_h=-(-max(r[3] for r in rois) // 64) * 64,
        pad_w=-(-max(r[2] for r in rois) // 64) * 64)
    stack, masks = np.asarray(stack), np.asarray(masks)
    cut = [masks[i, :rois[i][3], :rois[i][2]] for i in range(3)]
    return (stack, cut, [r[:2] for r in rois],
            jwarps.u_period("spherical", warper.scale))


def _both(stack, masks, corners, seam_type, period=None):
    want = jseams.find_seams(None, corners, [m.copy() for m in masks],
                             seam_type, images_dev=jnp.asarray(stack),
                             period=period)
    got = seams.find_seams(corners, [m.copy() for m in masks], seam_type,
                           images_dev=t(stack), period=period)
    return want, got


@pytest.mark.parametrize("seam_type", ["dp_color", "dp_colorgrad"])
def test_dp_seams_equal_on_ring(ring_stack, seam_type):
    """Bit-equal masks: the costs are square roots of integer sums and the
    DP adds and compares in the reference's order."""
    stack, masks, corners, period = ring_stack
    want, got = _both(stack, masks, corners, seam_type, period)
    changed = 0
    for a, b, m in zip(want, got, masks):
        np.testing.assert_array_equal(b > 0, a > 0)
        changed += int(((m > 0) & (b == 0)).sum())
    assert changed > 100   # the seams did cut the overlaps


@pytest.mark.parametrize("seam_type", ["dp_color", "dp_colorgrad"])
def test_dp_seams_two_components(seam_type):
    """A hand-built pair whose overlap has two connected components (a
    hole splits it), plus a third image offset vertically so that both
    seam orientations (transposed tasks) run."""
    rng = np.random.default_rng(3)
    h, w = 60, 80
    stack = rng.integers(0, 256, (3, h, w, 3)).astype(np.uint8)
    corners = [(0, 0), (40, 0), (20, 34)]
    masks = [np.full((h, w), 255, np.uint8) for _ in range(3)]
    masks[1][:, 10:16] = 0                # splits the 0-1 overlap
    masks[1][:, :10][20:40] = 0
    want, got = _both(stack, masks, corners, seam_type)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b > 0, a > 0)
    # The union of the seam masks still covers the union of the masks.
    canvas_w = np.zeros((h + 34, w + 40), bool)
    canvas_s = np.zeros_like(canvas_w)
    for (x, y), m, s in zip(corners, masks, got):
        canvas_w[y:y + h, x:x + w] |= m > 0
        canvas_s[y:y + h, x:x + w] |= s > 0
    np.testing.assert_array_equal(canvas_s, canvas_w)


def test_dp_seam_primitives():
    """The batched DP (accumulate + backtrack) against the reference's
    single-crop `_dp_seam` with walls, one crop per orientation."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (2, 24, 32, 3)).astype(np.float32)
    b = rng.integers(0, 256, (2, 24, 32, 3)).astype(np.float32)
    valid = rng.random((2, 24, 32)) > 0.2
    cost = seams._dp_seam_cost(t(a), t(b))
    cost = torch.where(t(valid), cost, 0.0)
    cols = seams._dp_backtrack(seams._dp_accumulate(cost).numpy())
    for k, pref in enumerate((True, False)):
        keep = np.asarray(jseams._dp_seam(
            jnp.asarray(a[k]), jnp.asarray(b[k]), jnp.asarray(valid[k]),
            jnp.asarray(pref)))
        left = np.arange(32)[None, :] <= cols[k][:, None]
        np.testing.assert_array_equal(np.where(pref, left, ~left), keep)


def test_find_seams_refusals():
    masks = [np.full((4, 5), 255, np.uint8)]
    with pytest.raises(ValueError, match="Can't create"):
        seams.find_seams([(0, 0)], masks, "bogus")
    with pytest.raises(ValueError, match="images_dev"):
        seams.find_seams([(0, 0)], masks, "gc_color")
    with pytest.raises(ValueError, match="images_dev"):
        seams.find_seams([(0, 0)], masks, "dp_color")
    assert seams.periodic_corner((0, 0), (10, 5), (95, 0), (10, 5), 100) == \
        jseams.periodic_corner((0, 0), (10, 5), (95, 0), (10, 5), 100)


def _host_images(stack, masks):
    """The reference's host images: each padded rect cut to its ROI, as
    float32 (what its pipeline downloads for the graph cut)."""
    return [np.asarray(stack[i, :m.shape[0], :m.shape[1]], np.float32)
            for i, m in enumerate(masks)]


def _two_component_scene():
    rng = np.random.default_rng(3)
    h, w = 60, 80
    stack = rng.integers(0, 256, (3, h, w, 3)).astype(np.uint8)
    corners = [(0, 0), (40, 0), (20, 34)]
    masks = [np.full((h, w), 255, np.uint8) for _ in range(3)]
    masks[1][:, 10:16] = 0
    masks[1][:, :10][20:40] = 0
    return stack, masks, corners, None


@pytest.mark.parametrize("seam_type", ["voronoi", "gc_color",
                                       "gc_colorgrad"])
@pytest.mark.parametrize("scene", ["ring", "two components"])
def test_voronoi_and_graph_cut_equal(ring_stack, seam_type, scene):
    """Bit-equal masks: the native EDT on both sides for voronoi; for the
    graph cuts the same integer-scaled costs (square roots of integer sums,
    computed on the device in the port) and the same scipy max-flow."""
    stack, masks, corners, period = (ring_stack if scene == "ring"
                                     else _two_component_scene())
    want = jseams.find_seams(_host_images(stack, masks), corners,
                             [m.copy() for m in masks], seam_type,
                             images_dev=jnp.asarray(stack), period=period)
    got = seams.find_seams(corners, [m.copy() for m in masks], seam_type,
                           images_dev=t(stack), period=period)
    changed = 0
    for a, b, m in zip(want, got, masks):
        np.testing.assert_array_equal(b > 0, a > 0)
        changed += int(((m > 0) & (b == 0)).sum())
    assert changed > 100


def _strict_scenes():
    """tests/test_seam_strict.py's scenes: two images side by side, and
    three staggered rects with a three-way overlap band (float images)."""
    rng = np.random.default_rng(0)
    h, w = 48, 64
    two = [rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
           for _ in range(2)]
    three = [rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
             for _ in range(3)]
    return {"two": (two, [(0, 0), (w // 2, 0)]),
            "three": (three, [(0, 0), (20, 6), (40, 12)])}


@pytest.mark.parametrize("scene", ["two", "three"])
@pytest.mark.parametrize("strict", [True, False])
def test_dp_strict_equal(scene, strict):
    """strict=True (pairs in OpenCV's order, each labelled from the evolved
    masks) and the batched default, bit-equal to the reference's on the
    strict-mode test scenes."""
    imgs, corners = _strict_scenes()[scene]
    masks = [np.full(im.shape[:2], 255, np.uint8) for im in imgs]
    stack = np.stack(imgs)
    want = jseams.find_seams(None, corners, [m.copy() for m in masks],
                             "dp_color", images_dev=jnp.asarray(stack),
                             strict=strict)
    got = seams.find_seams(corners, [m.copy() for m in masks], "dp_color",
                           images_dev=t(stack), strict=strict)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b > 0, a > 0)


def test_native_edt_equals_plain_distance():
    """The native O(HW) squared EDT against the port's plain `_distance_sq`
    and the reference's, on random masks with zeros, exactly."""
    rng = np.random.default_rng(6)
    far = 0.0
    for h, w, p in ((31, 47, 0.9), (64, 40, 0.99), (17, 90, 0.5)):
        mask = rng.random((h, w)) < p
        mask[rng.integers(0, h), rng.integers(0, w)] = False
        got = seams.edt_sq(mask)
        plain = n(seams._distance_sq(t(mask.astype(np.float32))))
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(plain, np.asarray(jseams._distance_sq(
            jnp.asarray(mask.astype(np.float32)))))
        far = max(far, float(got.max()))
    assert far > 25
