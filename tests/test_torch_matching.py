"""Port parity: Hamming 2-NN matching and RANSAC.

Some tests hold one stage alone: they recompute the reference's draws
with its own `_sample_valid_distinct` / `_sample_valid` from a key and
inject them into the port.  The others give both packages the same key:
the port draws the same numbers from it (`core/prng.py`,
tests/test_torch_prng.py), and pair p of `match_all_pairs` draws from
split(key, n_pairs)[p] alone, whatever the chunk."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_h_close, n, t
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops import matching as jm
from image_stitching_tpu.ops import ransac as jr
from image_stitching_tpu.ops.features import Features as JFeatures
from image_stitching_tpu.ops.features.orb import orb_detect_and_describe
from image_stitching_tpu_torch.core.prng import PRNGKey, split
from image_stitching_tpu_torch.interop import (features_from_numpy,
                                               pair_matches_from_numpy)
from image_stitching_tpu_torch.kernels.hamming import pair_chunk
from image_stitching_tpu_torch.ops import matching, ransac
from image_stitching_tpu_torch.ops.features import Features
from image_stitching_tpu_torch.ops.features.orb import (
    orb_detect_and_describe as port_orb)
from image_stitching_tpu_torch.ops.imgproc import rgb_to_gray


def _draws(key, valid, n_hyp=512):
    """The reference's hypothesis and scoring indices for one pair."""
    v = jnp.asarray(valid)
    hyp = jr._sample_valid_distinct(key, v, n_hyp, 4)
    sub = jr._sample_valid(jax.random.fold_in(key, 1), v,
                           (min(v.shape[0], 1024),))
    return t(np.asarray(hyp))[None].long(), t(np.asarray(sub))[None].long()


@pytest.fixture(scope="module")
def ring_features():
    images, _, _ = make_ring_captures(n_images=3, hw=(160, 224), fov_deg=55,
                                      overlap_ratio=0.55)
    feats = [orb_detect_and_describe(jimg.rgb_to_gray(jnp.asarray(im)),
                                     n_features=400) for im in images]
    return [jax.tree.map(np.asarray, f) for f in feats]


def test_hamming_and_two_nn_equal():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (50, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (70, 8), dtype=np.uint64).astype(np.uint32)
    b[5] = a[3]                                    # an exact match
    b[9] = b[5]                                    # and a tie
    valid = rng.random(70) > 0.1
    want = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = matching.hamming_matrix(t(a), t(b))
    np.testing.assert_array_equal(n(got), want)
    ref = jm._two_nn(jnp.asarray(want, jnp.float32), jnp.asarray(valid))
    out = matching.two_nn(got.float(), t(valid))
    for r_, o in zip(ref, out):
        np.testing.assert_array_equal(n(o), np.asarray(r_))


@pytest.mark.parametrize("words", [1, 5, 12, 32])
def test_hamming_matrix_at_word_counts(words):
    """ops/matching.py's hamming_matrix (the plain bit-plane product, the
    reference's is XLA) equals the JAX function at other word counts,
    with all-zero and all-one words and the top bit set."""
    rng = np.random.default_rng(words)
    a = rng.integers(0, 2 ** 32, (40, words), dtype=np.uint64).astype(
        np.uint32)
    b = rng.integers(0, 2 ** 32, (33, words), dtype=np.uint64).astype(
        np.uint32)
    a[0], a[1], b[0] = 0, 0xFFFFFFFF, 0x80000000
    want = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = matching.hamming_matrix(t(a), t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), want)
    assert want[1, 0] == 32 * words - words


def test_ransac_injected_hypotheses():
    """Inlier masks and counts equal, H within rtol 1e-4."""
    rng = np.random.default_rng(1)
    m = 300
    src = rng.uniform(0, 400, (m, 2)).astype(np.float32)
    h_true = np.array([[1.02, 0.03, 40.0], [-0.02, 0.99, -12.0],
                       [1e-5, -2e-5, 1.0]])
    q = np.c_[src, np.ones(m)] @ h_true.T
    dst = (q[:, :2] / q[:, 2:]).astype(np.float32)
    dst += rng.normal(0, 0.5, dst.shape).astype(np.float32)
    dst[:60] = rng.uniform(0, 400, (60, 2))        # outliers
    valid = rng.random(m) > 0.05
    key = jax.random.PRNGKey(3)
    h_ref, mask_ref, n_ref = jr.ransac_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key)
    hyp, sub = _draws(key, valid)
    h, mask, cnt = ransac.ransac_homography(
        t(src)[None], t(dst)[None], t(valid)[None], hyp_idx=hyp,
        score_idx=sub)
    assert int(cnt[0]) == int(n_ref)
    np.testing.assert_array_equal(n(mask[0]), np.asarray(mask_ref))
    assert_h_close(n(h[0]), h_ref)


@pytest.mark.parametrize("pair", [(0, 1), (1, 2)])
def test_match_pair_equal_given_identical_descriptors(ring_features, pair):
    fa, fb = (ring_features[i] for i in pair)
    key = jax.random.PRNGKey(7)
    ref = jax.tree.map(np.asarray, jm.match_pair(
        JFeatures(*map(jnp.asarray, (fa.xy, fa.response, fa.angle, fa.octave,
                                     fa.size, fa.desc, fa.valid))),
        JFeatures(*map(jnp.asarray, (fb.xy, fb.response, fb.angle, fb.octave,
                                     fb.size, fb.desc, fb.valid))), key))
    hyp, sub = _draws(key, ref.valid)
    ta = Features.stack([features_from_numpy(fa, device="cpu")])
    tb = Features.stack([features_from_numpy(fb, device="cpu")])
    got = matching.match_pairs(ta, tb, hyp_idx=hyp, score_idx=sub)
    want = pair_matches_from_numpy(ref, device="cpu")
    for name, g in zip(("a_idx", "b_idx", "valid", "inlier"), got):
        assert torch.equal(g[0], want[name].to(g.dtype)), name
    h, ninl, conf = got[4:]
    assert int(ninl[0]) == int(want["num_inliers"]) > 8
    np.testing.assert_allclose(float(conf[0]), float(want["confidence"]),
                               rtol=1e-6)
    assert_h_close(n(h[0]), n(want["h"]))


def test_match_all_pairs_tables(ring_features):
    """Deterministic parts of the all-pairs graph (ratio-test matches,
    pair_cap compaction, counts) equal; confidences agree (the same key,
    so the same hypotheses)."""
    stack = JFeatures(*(jnp.stack([jnp.asarray(getattr(f, name))
                                   for f in ring_features])
                        for name in ("xy", "response", "angle", "octave",
                                     "size", "desc", "valid")))
    ref = jax.tree.map(np.asarray, jm.match_all_pairs(
        stack, jax.random.PRNGKey(0), pair_cap=400))
    got = matching.match_all_pairs(
        Features.stack([features_from_numpy(f, device="cpu")
                        for f in ring_features]),
        PRNGKey(0, "cpu"), pair_cap=400).numpy()
    for name in ("ii", "jj", "a_idx", "b_idx", "valid", "num_matches"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    np.testing.assert_allclose(got.confidence, ref.confidence, rtol=0,
                               atol=0.15)
    assert (got.confidence > 0.95).sum() == (ref.confidence > 0.95).sum()


@pytest.mark.parametrize("chunk", [1, 2])
def test_match_all_pairs_slices_the_one_two_nn_call(ring_features,
                                                    monkeypatch, chunk):
    """match_all_pairs takes the 2-NN of all pairs from one
    `hamming_two_nn_pairs` call and hands each RANSAC chunk its slice: with
    chunks of 1 and 2 of the 3 pairs, the ratio-test tables still equal
    the reference's."""
    stack = JFeatures(*(jnp.stack([jnp.asarray(getattr(f, name))
                                   for f in ring_features])
                        for name in ("xy", "response", "angle", "octave",
                                     "size", "desc", "valid")))
    ref = jax.tree.map(np.asarray, jm.match_all_pairs(
        stack, jax.random.PRNGKey(0)))
    calls = []
    real = matching.hamming_two_nn_pairs
    monkeypatch.setattr(matching, "pair_chunk", lambda k: chunk)
    monkeypatch.setattr(matching, "hamming_two_nn_pairs",
                        lambda *a: calls.append(a) or real(*a))
    got = matching.match_all_pairs(
        Features.stack([features_from_numpy(f, device="cpu")
                        for f in ring_features]),
        PRNGKey(0, "cpu")).numpy()
    assert len(calls) == 1 and calls[0][2].tolist() == [0, 0, 1]
    for name in ("ii", "jj", "a_idx", "b_idx", "valid", "num_matches"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_pair_draws_depend_on_its_key_alone(ring_features, monkeypatch,
                                            chunk):
    """Pair p of match_all_pairs draws from split(key, 3)[p] and nothing
    else: in chunks of 1, 2 or 3 pairs and in draw blocks of 2 or 4096
    pairs, each pair's uniforms come from its own key, and its inlier
    mask, n_inliers and H equal one match_pair call with that key, which
    sees no other pair."""
    tf = [features_from_numpy(f, device="cpu") for f in ring_features]
    key = PRNGKey(0, "cpu")
    real = matching.ransac_draws
    for block in (2, 4096):
        keys_seen = []

        def draws_watch(k, *a, **kw):
            keys_seen.append(k.clone())
            return real(k, *a, **kw)
        monkeypatch.setattr(matching, "pair_chunk", lambda k: chunk)
        monkeypatch.setattr(matching, "DRAW_PAIRS", block)
        monkeypatch.setattr(matching, "ransac_draws", draws_watch)
        got = matching.match_all_pairs(Features.stack(tf), key)
        assert len(keys_seen) == -(-3 // (chunk * max(1, block // chunk)))
        assert torch.equal(torch.cat(keys_seen), split(key, 3))
        for p, (i, j) in enumerate(((0, 1), (0, 2), (1, 2))):
            one = matching.match_pair(tf[i], tf[j], split(key, 3)[p])
            assert torch.equal(got.inlier[p], one.inlier)
            assert int(got.num_inliers[i, j]) == int(one.num_inliers)
            assert_h_close(n(got.h[i, j]), n(one.h))
        assert int(got.num_inliers[0, 1]) > 8


@pytest.fixture(scope="module")
def ring5_graph():
    """A 5-view ring's port ORB features on the CPU and its MatchGraph at
    the default block (all 10 pairs in one)."""
    images, _, _ = make_ring_captures(n_images=5, hw=(160, 224), fov_deg=40,
                                      overlap_ratio=0.55)
    feats = Features.stack([port_orb(rgb_to_gray(torch.from_numpy(
        np.asarray(im)).to(torch.float32)), n_features=400) for im in images])
    return feats, matching.match_all_pairs(feats, PRNGKey(3, "cpu"))


@pytest.mark.parametrize("block", [1, 2, 3, "all"])
def test_match_all_pairs_blocking_is_invisible(ring5_graph, monkeypatch,
                                               block):
    """Each pair draws from its own key, so the RANSAC block size leaves
    the MatchGraph unchanged bit for bit: blocks of 1, 2, 3 and all 10
    pairs of a 5-view ring give the default call's graph."""
    feats, want = ring5_graph
    size = 10 if block == "all" else block
    sizes = []

    def chunk(*args):
        sizes.append(args)
        return size
    monkeypatch.setattr(matching, "ransac_chunk", chunk)
    got = matching.match_all_pairs(feats, PRNGKey(3, "cpu"))
    assert sizes == [(400, True, "homography", torch.device("cpu"))]
    for name in ("ii", "jj", "a_idx", "b_idx", "valid", "inlier", "h",
                 "num_inliers", "confidence", "num_matches"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int((want.num_inliers > 20).sum()) >= 6


@pytest.mark.parametrize("binary,matcher,device,budgeted", [
    (True, "homography", "cuda", True), (False, "homography", "cuda", False),
    (True, "affine", "cuda", False), (True, "homography", "cpu", False),
    (False, "affine", "cpu", False)])
def test_ransac_chunk_choice(binary, matcher, device, budgeted):
    """The block is RANSAC's own byte budget on the K4 route with the
    homography matcher on CUDA (K7 forms no (P, n_hyp, m) tensors there),
    and the plain path's `pair_chunk(K)` for float descriptors, the affine
    matcher and the CPU."""
    for k in (400, 1000, 4000):
        got = matching.ransac_chunk(k, binary, matcher, torch.device(device))
        if budgeted:
            assert got == matching.ransac_pairs(2 * k) == (
                matching.RANSAC_BYTES // (matching.RANSAC_SLOT_BYTES * 2 * k))
            assert got > pair_chunk(k)
        else:
            assert got == pair_chunk(k)
    assert matching.ransac_pairs(10 ** 9) == 1


# The 4000 full-resolution ORB features of each image of the sigma-4
# 8 x 2448x3264 e2e ring, as the port's default-configuration stitch on an
# H100 handed them to matching, with that stitch's adjacent-pair n_matches
# and n_inliers: `python3 -m tools.ring_features <this file> 4` on a GPU.
RING_FEATURES = os.path.join(os.path.dirname(__file__), "data",
                             "ring_sigma4_features.npz")


@pytest.fixture(scope="module")
def ring_full():
    z = dict(np.load(RING_FEATURES))
    zeros = np.zeros(z["valid"].shape, np.float32)
    feats = JFeatures(xy=z["xy"], response=zeros, angle=zeros,
                      octave=zeros.astype(np.int32), size=zeros,
                      desc=z["desc"].view(np.uint32), valid=z["valid"])
    return feats, z


@pytest.mark.parametrize("a", range(7))
def test_full_resolution_ring_pair(ring_full, a):
    """Adjacent pair (a, a + 1) at the default K = 4000, where the
    near-duplicate rule (conf > 3 -> 0) decides which images stay: the
    reference's match_pair, with the key its stitch gives the pair, against
    the port's match_pairs with the reference's draws injected.  The
    ratio-test matches are equal, and n_matches also equals the port's CUDA
    stitch's (K4 there, the plain 2-NN here); H within rtol 1e-4 as above;
    the inlier masks differ only where a correspondence's squared error
    under the reference's H lies within 1e-3 of (3 px)^2 relative, which
    the float32 rounding of the IRLS refit decides; both zero the pair or
    neither does."""
    feats, z = ring_full
    iu, ju = np.triu_indices(feats.xy.shape[0], 1)
    p = int(np.flatnonzero((iu == a) & (ju == a + 1))[0])
    key = jax.random.split(jax.random.PRNGKey(JConfig().seed), len(iu))[p]
    fa, fb = (jax.tree.map(lambda x, i=i: x[i], feats) for i in (a, a + 1))
    ref = jax.tree.map(np.asarray, jm.match_pair(
        jax.tree.map(jnp.asarray, fa), jax.tree.map(jnp.asarray, fb), key))
    hyp, sub = _draws(key, ref.valid)
    got = matching.match_pairs(
        Features.stack([features_from_numpy(fa, device="cpu")]),
        Features.stack([features_from_numpy(fb, device="cpu")]),
                               hyp_idx=hyp, score_idx=sub)
    want = pair_matches_from_numpy(ref, device="cpu")
    for name, g in zip(("a_idx", "b_idx", "valid"), got):
        assert torch.equal(g[0], want[name].to(g.dtype)), name
    n_matches = int(ref.valid.sum())
    assert n_matches == int(z["n_matches"][a])
    assert_h_close(n(got[4][0]), ref.h)
    src, dst = fa.xy[ref.a_idx], fb.xy[ref.b_idx]
    q = np.c_[src, np.ones(len(src))] @ ref.h.astype(np.float64).T
    err2 = np.sum((q[:, :2] / q[:, 2:] - dst) ** 2, axis=-1)
    flipped = n(got[3][0]) != ref.inlier
    assert np.all(np.abs(err2[flipped] / 9.0 - 1.0) <= 1e-3)
    assert abs(int(got[5][0]) - int(ref.num_inliers)) <= int(flipped.sum())
    assert (float(got[6][0]) == 0.0) == (float(ref.confidence) == 0.0)
    print(f"pair {a}-{a + 1}: n_matches {n_matches}; n_inliers / (8 + 0.3 "
          f"n_matches): reference {int(ref.num_inliers)}, "
          f"{int(ref.num_inliers) / (8.0 + 0.3 * n_matches):.4f}; port, "
          f"reference's draws {int(got[5][0])} ({int(flipped.sum())} "
          f"flipped at the threshold); port's CUDA stitch, its own draws "
          f"{int(z['n_inliers'][a])}, "
          f"{int(z['n_inliers'][a]) / (8.0 + 0.3 * n_matches):.4f}")
