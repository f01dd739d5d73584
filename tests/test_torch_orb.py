"""Port parity: ORB detect/describe and kernel K1 (orb_sample)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, n, t
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.kernels.orb_sample_pallas import orb_sample_pallas
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops.features import orb as jorb
from image_stitching_tpu_torch.kernels.orb_sample import (
    orb_sample_levels, orb_sample_levels_plain, orb_sample_plain)
from image_stitching_tpu_torch.ops.features import orb as torb


def _setup(seed=0, h=120, w=260, k=23):
    """Random planes and in-border keypoints, as
    tests/test_orb_sample_pallas.py builds them."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    blur = rng.uniform(0, 255, (h, w)).astype(np.float32)
    xy = np.stack([rng.uniform(22, w - 23, k),
                   rng.uniform(22, h - 23, k)], -1).astype(np.float32)
    pattern = jorb.resolve_pattern(None, 40)
    pat_xy = n(torb.pattern_xy(pattern, "cpu"))
    return img, blur, xy, pattern, pat_xy


def _moment_scale(img, xy, radius=20):
    """Sum of |v * d| over each keypoint's disk: the magnitude float32
    summation error scales with (the moments themselves may cancel)."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = xs * xs + ys * ys <= radius * radius
    cx = np.round(xy[:, 0]).astype(int)
    cy = np.round(xy[:, 1]).astype(int)
    v = img[cy[:, None] + ys[disk][None], cx[:, None] + xs[disk][None]]
    return np.stack([(v * np.abs(xs[disk])).sum(1),
                     (v * np.abs(ys[disk])).sum(1)], -1)


def _bits(words):
    w = np.asarray(words).astype(np.uint32)
    return (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1


@pytest.mark.parametrize("seed", [0, 3])
def test_k1_plain_vs_pallas_interpret(seed):
    img, blur, xy, pattern, pat_xy = _setup(seed)
    samples, ang, mom = orb_sample_pallas(
        jnp.asarray(img), jnp.asarray(blur), jnp.asarray(xy),
        jnp.asarray(pat_xy), radius=20, span=max(jorb._pattern_span(pattern),
                                                 20), interpret=True)
    s, a, m, d = orb_sample_plain(t(img), t(blur), t(xy), t(pat_xy), 20)
    # Moments: rtol 1e-5 of the disk's |v * d| magnitude (summation order).
    np.testing.assert_array_less(np.abs(n(m) - np.asarray(mom)),
                                 1e-5 * _moment_scale(img, xy) + 1e-6)
    # Angle: both wrappers return atan2(m01, m10); atol 1e-4 rad covers
    # the moments' summation-order error.
    np.testing.assert_allclose(n(a), np.asarray(ang), rtol=0, atol=1e-4)
    # Descriptor bits: the Pallas kernel rotates by m/|m|, the plain
    # version by cos/sin(atan2(m)); a bit flips only at an exact .5
    # rounding boundary.  Held to <= 1e-3 of the bits (measured: 0).
    s_ref = np.asarray(samples)
    want = _bits(jorb._pack_bits(jnp.asarray(s_ref[:, :256] <
                                             s_ref[:, 256:])))
    flips = int((_bits(n(d)) != want).sum())
    assert flips <= 1e-3 * want.size, flips


@pytest.mark.parametrize("seed", [1, 7])
def test_k1_plain_vs_xla_path_bit_equal(seed):
    """Against `_orientations` + `_describe_impl`: equal descriptor words,
    angles within float32 summation error of the moments."""
    img, blur, xy, pattern, pat_xy = _setup(seed, h=96, w=384, k=41)
    angle = jorb._orientations(jnp.asarray(img), jnp.asarray(xy), 20)
    desc = jorb._describe(jnp.asarray(blur), jnp.asarray(xy), angle,
                          pattern)
    _, a, _, d = orb_sample_plain(t(img), t(blur), t(xy), t(pat_xy), 20)
    np.testing.assert_array_equal(n(d), np.asarray(desc).view(np.int32))
    np.testing.assert_allclose(n(a),
                               np.asarray(angle), rtol=0, atol=1e-4)


def _levels(seed, sizes=((120, 260), (100, 216), (83, 180)), k=(23, 15, 9)):
    """Level planes of three sizes and each level's in-border keypoints,
    concatenated in level order with their level index."""
    raws, blurs, xys, lvl = [], [], [], []
    for i, ((h, w), k_l) in enumerate(zip(sizes, k)):
        img, blur, xy, _, pat_xy = _setup(seed + i, h, w, k_l)
        raws.append(t(img))
        blurs.append(t(blur))
        xys.append(t(xy))
        lvl.append(torch.full((k_l,), i, dtype=torch.int32))
    return raws, blurs, torch.cat(xys), torch.cat(lvl), t(pat_xy)


def test_k1_wrapper_checks_inputs():
    raws, blurs, xy, lvl, pat = _levels(0)
    with pytest.raises(ValueError):
        orb_sample_levels(raws, [blurs[0][:-1]] + blurs[1:], xy, lvl, pat, 20)
    with pytest.raises(TypeError):
        orb_sample_levels([raws[0].double()] + raws[1:], blurs, xy, lvl, pat,
                          20)
    with pytest.raises(ValueError):
        orb_sample_levels(raws, blurs, xy, lvl, pat[:, :256], 20)
    with pytest.raises(TypeError):
        orb_sample_levels(raws, blurs, xy, lvl.long(), pat, 20)
    with pytest.raises(ValueError):
        orb_sample_levels(raws, blurs, xy, lvl[:-1], pat, 20)
    with pytest.raises(ValueError):
        orb_sample_levels(raws * 3, blurs * 3, xy, lvl, pat, 20)
    with pytest.raises(ValueError):
        orb_sample_levels(raws, blurs, xy, lvl, pat, 32)


@pytest.mark.parametrize("seed", [0, 4])
def test_k1_levels_plain_equals_per_level(seed):
    """One call over all levels gives each level's keypoints what
    `orb_sample_plain` gives them on that level alone, bit for bit."""
    raws, blurs, xy, lvl, pat = _levels(seed)
    s, a, m, d = orb_sample_levels(raws, blurs, xy, lvl, pat, 20,
                                   with_samples=True)
    assert orb_sample_levels(raws, blurs, xy, lvl, pat, 20)[0] is None
    for i, (raw, blur) in enumerate(zip(raws, blurs)):
        sel = lvl == i
        want = orb_sample_plain(raw, blur, xy[sel], pat, 20)
        for got, w in zip((s[sel], a[sel], m[sel], d[sel]), want):
            assert torch.equal(got, w)


def test_pack_bits_matches_reference():
    bits = np.random.default_rng(5).random((9, 256)) > 0.5
    want = np.asarray(jorb._pack_bits(jnp.asarray(bits))).view(np.int32)
    from image_stitching_tpu_torch.kernels.orb_sample import pack_bits
    np.testing.assert_array_equal(n(pack_bits(t(bits))), want)


@pytest.fixture(scope="module")
def ring_gray():
    images, _, _ = make_ring_captures(n_images=2, hw=(160, 224), fov_deg=55,
                                      overlap_ratio=0.55)
    return [np.asarray(jimg.rgb_to_gray(jnp.asarray(im))) for im in images]


@pytest.mark.parametrize("idx", [0, 1])
def test_orb_end_to_end_on_ring(ring_gray, idx):
    """Keypoints, validity and descriptors of the whole detector.  Harris
    sums may differ in the last ulp from XLA's (fused) order, which moves
    subpixel offsets by ulps and could reorder near-ties of the top-k; so
    at least 99% of keypoints must be identical (measured on these
    captures: 100% of valid flags and descriptors, offsets within 1e-5)."""
    g = ring_gray[idx]
    ref = jorb.orb_detect_and_describe(jnp.asarray(g), n_features=400)
    got = torb.orb_detect_and_describe(t(g), n_features=400)
    valid = np.asarray(ref.valid)
    assert (n(got.valid) == valid).mean() >= 0.99
    assert valid.sum() > 200
    same_xy = np.all(np.abs(n(got.xy) - np.asarray(ref.xy)) <= 1e-3, -1)
    same_desc = np.all(n(got.desc) == np.asarray(ref.desc).view(np.int32),
                       -1)
    assert (same_xy & same_desc)[valid].mean() >= 0.99
    np.testing.assert_array_equal(n(got.octave), np.asarray(ref.octave))


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_cuda():
    dev = cuda_device()
    raws, blurs, xy, lvl, pat = _levels(2, sizes=((300, 400), (250, 333)),
                                        k=(300, 200))
    raws, blurs = [x.to(dev) for x in raws], [x.to(dev) for x in blurs]
    xy, lvl, pat = xy.to(dev), lvl.to(dev), pat.to(dev)
    before = orb_sample_levels.launches
    _, a, m, d = orb_sample_levels(raws, blurs, xy, lvl, pat, 20)
    torch.cuda.synchronize()
    assert orb_sample_levels.launches == before + 1
    assert tuple(a.shape) == (500,) and bool(torch.isfinite(a).all())
    _, _, m0, d0 = orb_sample_levels_plain(raws, blurs, xy, lvl, pat, 20)
    for i, raw in enumerate(raws):
        sel = n(lvl) == i
        np.testing.assert_array_less(
            np.abs(n(m)[sel] - n(m0)[sel]),
            1e-5 * _moment_scale(n(raw), n(xy)[sel]) + 1e-6)
    assert int((_bits(n(d)) != _bits(n(d0))).sum()) <= 1e-4 * 500 * 256


def _plain_coords(xy, angle, pat_xy, h, w):
    """orb_sample_plain's rounded, clipped endpoint coordinates."""
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px, py = pat_xy[0][None], pat_xy[1][None]
    gx = torch.clamp(torch.round(xy[:, 0:1] + (ca * px - sa * py)), 0, w - 1)
    gy = torch.clamp(torch.round(xy[:, 1:2] + (sa * px + ca * py)), 0, h - 1)
    return n(gx), n(gy)


def _quotient_coords(xy, mom, pat_xy, h, w):
    """The Pallas kernels' endpoint coordinates: rotation by m / |m|."""
    m10, m01 = mom[:, 0:1], mom[:, 1:2]
    nrm = np.sqrt(m10 * m10 + m01 * m01)
    safe = np.maximum(nrm, np.float32(1e-30))
    ca = np.where(nrm > 0, m10 / safe, 1.0).astype(np.float32)
    sa = np.where(nrm > 0, m01 / safe, 0.0).astype(np.float32)
    gx = np.round(xy[:, 0:1] + ca * pat_xy[0] - sa * pat_xy[1])
    gy = np.round(xy[:, 1:2] + sa * pat_xy[0] + ca * pat_xy[1])
    return np.clip(gx, 0, w - 1), np.clip(gy, 0, h - 1)


@pytest.mark.parametrize("seed", [3, 5])
def test_k3_plain_vs_stream_pallas_interpret(seed):
    """K3: `orb_sample_stream_pallas`, which the TPU takes for level planes
    past its 11 MB VMEM budget, run by the Pallas interpreter at
    tests/test_orb_stream_pallas.py's shape, against K1's plain version,
    which the port runs at every level whatever the plane's size.  Samples
    are equal wherever both rotations round to the same coordinates; the
    descriptor bits are counted as in the K1 test (the Pallas kernels
    rotate by m / |m|, the port by cos/sin(atan2)), <= 1e-3 of the bits."""
    from image_stitching_tpu.kernels.orb_stream_pallas import \
        orb_sample_stream_pallas
    img, blur, xy, pattern, pat_xy = _setup(seed)
    h, w = img.shape
    samples, ang, mom = orb_sample_stream_pallas(
        jnp.asarray(img), jnp.asarray(blur), jnp.asarray(xy),
        jnp.asarray(pat_xy), radius=20,
        span=max(jorb._pattern_span(pattern), 20), interpret=True)
    s, a, m, d = orb_sample_plain(t(img), t(blur), t(xy), t(pat_xy), 20)
    scale = _moment_scale(img, xy)
    np.testing.assert_array_less(np.abs(n(m) - np.asarray(mom)),
                                 1e-5 * scale + 1e-6)
    # Angle: the moments' error over their length (a cancelled sum turns
    # the same absolute error into a larger angle).
    np.testing.assert_array_less(
        np.abs(n(a) - np.asarray(ang)),
        1e-5 * np.linalg.norm(scale, axis=1) /
        np.linalg.norm(np.asarray(mom), axis=1) + 1e-6)
    gx, gy = _plain_coords(t(xy), a, t(pat_xy), h, w)
    qx, qy = _quotient_coords(xy, np.asarray(mom), pat_xy, h, w)
    agree = (gx == qx) & (gy == qy)
    assert agree.mean() >= 0.99
    np.testing.assert_array_equal(n(s)[agree], np.asarray(samples)[agree])
    s_ref = np.asarray(samples)
    want = _bits(jorb._pack_bits(jnp.asarray(s_ref[:, :256] <
                                             s_ref[:, 256:])))
    flips = int((_bits(n(d)) != want).sum())
    assert flips <= 1e-3 * want.size, flips
