"""Port parity: the SIFT, SURF and AKAZE detectors, their shared Hessian
machinery, kernel K4's plain version at AKAZE's 12 words, and the
squared-L2 matching of float descriptors.

The scenes are tests/test_features_matching.py's (a 256x192 cubic-upsampled
noise image and its perspective warp) and one 240x320 ring view, at
n_features=300.  Inputs are made with numpy from fixed seeds; the JAX side
runs as its own tests run it on the CPU."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import checked_keys, cuda_device, n, t
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops import matching as jm
from image_stitching_tpu.ops.features import Features as JFeatures
from image_stitching_tpu.ops.features import hessian as jh
from image_stitching_tpu.ops.features import sift as jsift
from image_stitching_tpu.ops.features.akaze import akaze_detect_and_describe
from image_stitching_tpu.ops.features.surf import surf_detect_and_describe
from image_stitching_tpu_torch.core.prng import PRNGKey
from image_stitching_tpu_torch.interop import features_from_numpy
from image_stitching_tpu_torch.kernels.hamming import (
    hamming_matrix, hamming_two_nn_pairs, hamming_two_nn_pairs_plain,
    pm1_rows)
from image_stitching_tpu_torch.ops import matching
from image_stitching_tpu_torch.ops.features import (
    Features, akaze, akaze_detect_and_describe as t_akaze, hessian, sift,
    sift_detect_and_describe as t_sift, surf_detect_and_describe as t_surf)

K = 300
BIG = 2.0 ** 30
DETECTORS = {
    "sift": (jsift.sift_detect_and_describe, t_sift),
    "surf": (surf_detect_and_describe, t_surf),
    "akaze": (akaze_detect_and_describe, t_akaze),
}
FIELDS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _ring_gray(hw=(240, 320), n_images=2):
    images, _, _ = make_ring_captures(n_images=n_images, hw=hw, fov_deg=55,
                                      overlap_ratio=0.55)
    return [np.asarray(jimg.rgb_to_gray(jnp.asarray(im))) for im in images]


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (40, 52)).astype(np.float32)
    img1 = cv2.resize(base, (256, 192), interpolation=cv2.INTER_CUBIC)
    h_true = np.float32([[0.98, 0.03, 18.0], [-0.02, 1.01, 6.0],
                         [1e-5, -1e-5, 1.0]])
    img2 = cv2.warpPerspective(img1, h_true, (256, 192))
    return {"img1": img1, "img2": img2, "ring": _ring_gray()[0]}


def _features(fn, img, torch_side):
    f = fn(torch.tensor(img) if torch_side else jnp.asarray(img),
           n_features=K)
    return {name: n(getattr(f, name)) for name in FIELDS}


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))


def _hold_features(ref, got, feat):
    """The detector's tolerances: the valid mask equal; valid keypoints at
    the same slots with positions within 1e-3 px, a slot where they differ
    allowed only between responses within 1e-5 relative (a tie of the
    top-k, counted); angles within 1e-4 rad, a SIFT orientation flip
    between near-equal peaks allowed on under 1% of keypoints (counted);
    float descriptors within 1e-4 absolute, AKAZE's bits equal.  Returns
    the counts of order and orientation flips."""
    v = ref["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    assert v.sum() > 50, feat
    moved = np.abs(got["xy"] - ref["xy"]).max(-1) > 1e-3
    rel = (np.abs(got["response"] - ref["response"]) /
           np.maximum(np.abs(ref["response"]), 1e-12))
    assert (rel[v & moved] <= 1e-5).all(), (feat, int((v & moved).sum()))
    same = v & ~moved
    np.testing.assert_array_equal(got["octave"][same], ref["octave"][same])
    np.testing.assert_allclose(got["size"][same], ref["size"][same],
                               rtol=1e-5)
    turned = same & (_angle_diff(got["angle"], ref["angle"]) > 1e-4)
    assert turned.sum() <= (0.01 * v.sum() if feat == "sift" else 0), feat
    keep = same & ~turned
    if feat == "akaze":
        assert got["desc"].dtype == np.int32 and got["desc"].shape[-1] == 12
        np.testing.assert_array_equal(got["desc"][keep],
                                      ref["desc"].view(np.int32)[keep])
    else:
        assert got["desc"].dtype == np.float32
        np.testing.assert_allclose(got["desc"][keep], ref["desc"][keep],
                                   atol=1e-4, rtol=0)
    return int((v & moved).sum()), int(turned.sum())


@pytest.mark.parametrize("scene", ["img1", "img2", "ring"])
@pytest.mark.parametrize("feat", list(DETECTORS))
def test_detector_matches_reference(scenes, feat, scene):
    jfn, tfn = DETECTORS[feat]
    ref = _features(jfn, scenes[scene], False)
    got = _features(tfn, scenes[scene], True)
    assert got["desc"].shape == ref["desc"].shape
    flips, turned = _hold_features(ref, got, feat)
    # On these scenes the port reproduces the reference's rounding: no
    # order flip and no orientation flip.
    assert (flips, turned) == (0, 0)


def test_det_hessian_and_diffusion_bit_equal():
    """The two stencils round as the reference's contraction: bit-equal,
    also after 18 chained diffusion steps (AKAZE's three layers)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (61, 83)).astype(np.float32)
    np.testing.assert_array_equal(n(hessian.det_hessian(t(img))),
                                  np.asarray(jh.det_hessian(img)))
    xj, xt = jnp.asarray(img), t(img)
    for _ in range(18):
        xj, xt = jh.diffusion_step(xj), hessian.diffusion_step(xt)
    np.testing.assert_array_equal(n(xt), np.asarray(xj))


@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_keypoints_ties(seed):
    """A tie-heavy map (values on a coarse grid, most of it 0 after NMS,
    negative regions): the same slots, values, scales and valid mask,
    lax.top_k's lower-index-first order included."""
    rng = np.random.default_rng(seed)
    maps = [np.round(rng.normal(0, 2, (40, 50))).astype(np.float32)
            for _ in range(3)]
    maps[1][10:20, 10:30] = 3.0            # a plateau of equal maxima
    for k_total in (25, 400):
        ref = jh.top_k_keypoints([jnp.asarray(m) for m in maps], k_total,
                                 border=4)
        got = hessian.top_k_keypoints([t(m) for m in maps], k_total, border=4)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(n(g), np.asarray(r))


def test_dog_stack_and_extrema_mask():
    """The octave's blurred levels and DoG are bit-equal; the running
    neighbourhood max gives the reference's stacked-max extrema mask."""
    img = _ring_gray((120, 160), 1)[0]
    gj, dj = jsift._dog_stack(jnp.asarray(img), sigma_prev=0.5)
    gt, dt = sift.dog_stack(t(img), sigma_prev=0.5)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    np.testing.assert_array_equal(n(dt), np.asarray(dj))
    mask = n(sift.extrema_mask(dt))
    np.testing.assert_array_equal(mask, np.asarray(jsift._extrema_mask(dj)))
    assert mask.sum() > 10 and not mask[0].any() and not mask[-1].any()
    # Random DoG values with exact ties between neighbours.
    rng = np.random.default_rng(2)
    dog = np.round(rng.normal(0, 6, (5, 30, 40))).astype(np.float32)
    np.testing.assert_array_equal(n(sift.extrema_mask(t(dog))),
                                  np.asarray(jsift._extrema_mask(
                                      jnp.asarray(dog))))


def test_descr_grid_equal():
    offs, cell_w = sift.descr_grid()
    offs_j, cell_w_j = jsift._descr_grid()
    np.testing.assert_array_equal(offs, np.asarray(offs_j))
    np.testing.assert_array_equal(cell_w, np.asarray(cell_w_j))
    assert cell_w.shape == (1024, 16)


def test_akaze_pack_bits():
    """360 bits into 12 words, bit b of word w at 32 w + b, the last 24
    bits zero: the reference's uint32 words as int32."""
    rng = np.random.default_rng(3)
    bits = rng.random((7, 360)) < 0.5
    words = n(akaze.pack_bits(torch.as_tensor(bits)))
    assert words.shape == (7, 12) and words.dtype == np.int32
    unpacked = (words.view(np.uint32)[..., None] >>
                np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(unpacked.reshape(7, 384)[:, :360], bits)
    assert not unpacked.reshape(7, 384)[:, 360:].any()


def _stack12(seed, n_img=4, k=70):
    """Random 12-word descriptors with AKAZE's 24 zero padding bits, near
    copies, duplicate columns, invalid columns and an empty image."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n_img, k, 12), dtype=np.uint64).astype(
        np.uint32)
    d[..., 11] &= np.uint32(0xFF)
    flips = (rng.random((n_img - 1, 30, 12)) < 0.02).astype(np.uint32) << \
        rng.integers(0, 8, (n_img - 1, 30, 12)).astype(np.uint32)
    d[1:, :30] = d[0, :30] ^ flips
    d[1, 40] = d[1, 41] = d[1, 5]
    d[2, 50:60] = d[2, 50]
    valid = rng.random((n_img, k)) > 0.15
    valid[n_img - 1] = False
    iu, ju = np.triu_indices(n_img, 1)
    return d, valid, iu.astype(np.int32), ju.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_plain_at_12_words_matches_reference(seed):
    """The plain K4 at W = 12 equals the reference's hamming_matrix plus
    _two_nn, forward and on the transpose, exactly (i2 where d2 < 2^30)."""
    d, valid, iu, ju = _stack12(seed)
    got_f, got_r = hamming_two_nn_pairs(t(d), t(valid), t(iu), t(ju))
    for p, (a, b) in enumerate(zip(iu, ju)):
        dist = jm.hamming_matrix(jnp.asarray(d[a]), jnp.asarray(d[b]))
        np.testing.assert_array_equal(n(hamming_matrix(t(d[a]), t(d[b]))),
                                      np.asarray(dist))
        dist = dist.astype(jnp.float32)
        for got, m, vb in ((got_f, dist, valid[b]), (got_r, dist.T,
                                                     valid[a])):
            want = [np.asarray(x) for x in jm._two_nn(m, jnp.asarray(vb))]
            i1, d1, i2, d2 = (n(x[p]) for x in got)
            np.testing.assert_array_equal(i1, want[0])
            np.testing.assert_array_equal(d1, want[1])
            np.testing.assert_array_equal(d2, want[3])
            real = want[3] < BIG
            np.testing.assert_array_equal(i2[real], want[2][real])
    pa = n(pm1_rows(t(d[0])))
    assert pa.shape == (70, 384) and (pa[:, 360:] == 1).all()


def _jstack(feats):
    return JFeatures(*(jnp.stack([jnp.asarray(f[name]) for f in feats])
                       for name in FIELDS))


@pytest.mark.parametrize("feat", ["sift", "surf"])
def test_l2_match_all_pairs_matches_reference(feat):
    """match_all_pairs on float descriptors (the reference's SIFT and SURF
    features of three ring views) with the reference's key: the
    ratio-test tables and inlier masks equal, n_inliers equal, H within
    rtol 1e-4 of its max entry (tests/test_torch_matching.py's bound),
    confidences rtol 1e-6."""
    jfn, _ = DETECTORS[feat]
    feats = [_features(jfn, g, False)
             for g in _ring_gray((240, 320), 3)]
    seed = JConfig().seed
    ref = jax.tree.map(np.asarray, jm.match_all_pairs(
        _jstack(feats), jax.random.PRNGKey(seed), match_conf=0.65))
    stack = Features.stack([features_from_numpy(JFeatures(
        *(f[name] for name in FIELDS)), device="cpu") for f in feats])
    assert stack.desc.dtype == torch.float32
    with checked_keys(seed, 3) as drawn:
        got = matching.match_all_pairs(stack, PRNGKey(seed, "cpu"),
                                       match_conf=0.65).numpy()
    assert drawn[0] == 3
    for name in ("ii", "jj", "a_idx", "b_idx", "valid", "inlier",
                 "num_matches", "num_inliers"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (ref.num_inliers[0, 1], ref.num_inliers[1, 2]) > (8, 8)
    assert np.abs(got.h - ref.h).max() <= 1e-4 * np.abs(ref.h).max()
    np.testing.assert_allclose(got.confidence, ref.confidence, rtol=1e-6)


def test_l2_matrix_squared_and_clamped():
    """l2_matrix is the reference's squared L2, clamped at 0: rtol 1e-5
    and atol 1e-4, the float32 rounding of na + nb - 2 a.b at |a|^2 ~ 64,
    which is also what identical rows may leave above 0."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(30, 64)).astype(np.float32)
    b = np.concatenate([a[:5], rng.normal(size=(20, 64)).astype(np.float32)])
    want = np.asarray(jm.l2_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = n(matching.l2_matrix(t(a), t(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got >= 0).all() and np.allclose(np.diag(got[:5, :5]), 0,
                                            atol=1e-4)


@pytest.mark.cuda
def test_k4_kernel_at_12_words_matches_plain_on_cuda():
    """K4 at W = 12 on the card equals its plain version on the same CUDA
    tensors, so does the same kernel at W = 10, and W = 0 raises."""
    dev = cuda_device()
    d, valid, iu, ju = _stack12(5, n_img=4, k=1100)
    args = [t(x).to(dev) for x in (d, valid, iu, ju)]
    before = hamming_two_nn_pairs.launches
    got = hamming_two_nn_pairs(*args)
    torch.cuda.synchronize()
    assert hamming_two_nn_pairs.launches == before + 1
    cut = [args[0][..., :10].contiguous()] + args[1:]
    for call, out in ((args, got), (cut, hamming_two_nn_pairs(*cut))):
        for g, w in zip(out, hamming_two_nn_pairs_plain(*call)):
            i1, d1, i2, d2 = (n(x) for x in g)
            np.testing.assert_array_equal(i1, n(w[0]))
            np.testing.assert_array_equal(d1, n(w[1]))
            np.testing.assert_array_equal(d2, n(w[3]))
            real = n(w[3]) < BIG
            np.testing.assert_array_equal(i2[real], n(w[2])[real])
    with pytest.raises(ValueError, match="words"):
        hamming_two_nn_pairs(args[0][..., :0].contiguous(), *args[1:])
