"""Port parity: kernel K4 (`hamming_two_nn_pairs`) at descriptor word
counts other than ORB's 8 and AKAZE's 12.

The JAX package matches binary descriptors of any word count W
(`ops/matching.py`'s `hamming_matrix` and `_two_nn`); on CUDA the port
takes every W >= 1 to one kernel (`csrc/hamming_chunked.cu`), on 32-bit
(distance, column) keys while K <= 65536 and 32 W <= 65535 and on 64-bit
ones past either (`key_bits`).  On the CPU the wrapper runs its plain
version, held here to the JAX live route at W in {1, 3, 4, 13, 16, 32,
2048, 4096}, at W + z zero words, and through `match_pair` and
`match_all_pairs` on 16-word descriptors; and a plain emulation of the
kernel's walk (128-byte stages of depth, 128-column tiles, the
all-invalid skip, the key top-2 at both key widths) is held to the JAX
reference."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import checked_keys, cuda_device, n, t
from test_torch_hamming import BIG, _assert_two_nn_equal, _reference
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops import matching as jm
from image_stitching_tpu.ops.features import Features as JFeatures
from image_stitching_tpu.ops.features.orb import orb_detect_and_describe
from image_stitching_tpu_torch.core.prng import PRNGKey, split
from image_stitching_tpu_torch.interop import features_from_numpy
from image_stitching_tpu_torch.kernels.hamming import (
    hamming_two_nn_pairs, hamming_two_nn_pairs_plain, hamming_two_nn_plain,
    key_bits, max_k, pm1_rows, unpack_pm1)
from image_stitching_tpu_torch.ops import matching
from image_stitching_tpu_torch.ops.features import Features

WORDS = (1, 3, 4, 13, 16, 32)
FIELDS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _stack(seed, words, n_img=5, k=90):
    """An image stack of random `words`-word descriptors with near copies
    of image 0 (small, varied distances), duplicate columns (a tie for row
    10 forward), a duplicate row (a tie in reverse), a run of ten equal
    descriptors, invalid columns, one image with a single valid
    descriptor and one with none; and every pair i < j."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n_img, k, words), dtype=np.uint64).astype(
        np.uint32)
    flips = (rng.random((n_img - 1, 40, words)) < 0.02).astype(
        np.uint32) << rng.integers(0, 32, (n_img - 1, 40, words)).astype(
        np.uint32)
    d[1:, :40] = d[0, :40] ^ flips
    d[1, 50] = d[1, 10]
    d[1, 61] = d[1, 10]
    d[0, 55] = d[0, 12]
    d[2, 70:80] = d[2, 70]
    valid = rng.random((n_img, k)) > 0.15
    valid[1, 50] = valid[1, 61] = True
    valid[0, 12] = valid[0, 55] = True
    valid[1, 10] = False
    valid[n_img - 2] = False
    valid[n_img - 2, 33] = True
    valid[n_img - 1] = False
    iu, ju = np.triu_indices(n_img, 1)
    return d, valid, iu.astype(np.int32), ju.astype(np.int32)


def _args(d, valid, iu, ju, device="cpu"):
    return [t(x).to(device) for x in (d.view(np.int32), valid, iu, ju)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("words", WORDS)
def test_plain_matches_reference_at_any_width(words, seed):
    d, valid, iu, ju = _stack(seed + 10 * words, words)
    want_f, want_r = _reference(d, valid, iu, ju)
    got_f, got_r = hamming_two_nn_pairs(*_args(d, valid, iu, ju))
    _assert_two_nn_equal(got_f, want_f)
    _assert_two_nn_equal(got_r, want_r)
    # The cases the data was built for did occur.
    none = ju == len(valid) - 1
    one = ju == len(valid) - 2
    assert np.all(want_f[1][none] == BIG)
    assert np.all(want_f[1][one] < BIG) and np.all(want_f[3][one] == BIG)
    assert (want_f[1][~none] == want_f[3][~none]).any()
    assert (want_r[1][iu == 0] == want_r[3][iu == 0]).any()
    assert want_f[1][~none].max() <= 32 * words


@pytest.mark.parametrize("words,zeros", [(1, 1), (4, 12), (8, 8), (8, 5),
                                         (12, 4), (13, 19)])
def test_zero_words_change_nothing(words, zeros):
    """Words that are 0 in every descriptor agree in every pair of rows:
    the 2-NN at W + z words equals the 2-NN at W, bit for bit (the card
    tests' 16-word ring check rests on this)."""
    d, valid, iu, ju = _stack(words, words)
    wide = np.concatenate([d, np.zeros(d.shape[:2] + (zeros,), np.uint32)],
                          axis=-1)
    got = hamming_two_nn_pairs_plain(*_args(wide, valid, iu, ju))
    want = hamming_two_nn_pairs_plain(*_args(d, valid, iu, ju))
    for side_g, side_w in zip(got, want):
        for g, w in zip(side_g, side_w):
            assert torch.equal(g, w)


@pytest.mark.parametrize("k,words,bits", [
    (4000, 1, 32), (4000, 3, 32), (4000, 4, 32), (4000, 7, 32),
    (4000, 8, 32), (4000, 9, 32), (4000, 12, 32), (4000, 13, 32),
    (4000, 16, 32), (4000, 32, 32), (4000, 2047, 32),
    (65536, 8, 32), (65537, 8, 64), (4000, 2048, 64)])
def test_route_by_word_count(k, words, bits):
    """The kernel's key is 32 bits (d << 16 | column) while a column fits
    16 bits (K <= 65536) and a distance 16 (32 W <= 65535), else 64."""
    assert key_bits(k, words) == bits


@pytest.mark.parametrize("words", [0, -1, 2048, 4096])
def test_route_raises_outside_the_key(words):
    """W < 1 raises.  Past the 32-bit key's 2047 words the kernel takes
    64-bit keys, and the wrapper's plain version on the CPU (3 images of
    K = 64) equals the JAX package's `_two_nn(hamming_matrix(...))` both
    ways, exactly."""
    if words < 1:
        with pytest.raises(ValueError, match="1 or more"):
            key_bits(64, words)
        return
    assert key_bits(64, words) == 64
    d, valid, _, _ = _stack(words, words)
    # Images 0-2, columns 0-63: near copies and the tie at 50 and 61;
    # image 2 all the complement of image 1's row 0, which is then 32 W
    # (past a 16-bit distance) from every column of it.
    d, valid = d[:3, :64].copy(), valid[:3, :64]
    d[2] = ~d[1, 0]
    iu, ju = (x.astype(np.int32) for x in np.triu_indices(3, 1))
    want_f, want_r = _reference(d, valid, iu, ju)
    got_f, got_r = hamming_two_nn_pairs(*_args(d, valid, iu, ju))
    _assert_two_nn_equal(got_f, want_f)
    _assert_two_nn_equal(got_r, want_r)
    assert want_f[1][2, 0] == want_f[3][2, 0] == 32 * words > 65535
    assert (want_r[1] < 32 * words // 4).any()


def _wide(desc):
    """ORB's 8 words and each rotated left by 5 bits: a 16-word (512-bit)
    descriptor whose distances are twice the 8-word ones."""
    d = np.asarray(desc, np.uint32)
    return np.concatenate([d, (d << 5) | (d >> 27)], axis=-1)


@pytest.fixture(scope="module")
def ring16():
    """ORB features of a 3-view ring with 16-word descriptors."""
    images, _, _ = make_ring_captures(n_images=3, hw=(160, 224), fov_deg=55,
                                      overlap_ratio=0.55)
    feats = []
    for im in images:
        f = jax.tree.map(np.asarray, orb_detect_and_describe(
            jimg.rgb_to_gray(jnp.asarray(im)), n_features=400))
        feats.append(JFeatures(*(_wide(f.desc) if name == "desc"
                                 else getattr(f, name) for name in FIELDS)))
    assert feats[0].desc.shape == (400, 16)
    return feats


def _assert_pair_equal(got, want):
    for name in ("a_idx", "b_idx", "valid", "inlier", "num_inliers"):
        assert np.array_equal(n(getattr(got, name)),
                              np.asarray(getattr(want, name))), name
    np.testing.assert_allclose(n(got.confidence), np.asarray(want.confidence),
                               rtol=0, atol=1e-5)
    want_h = np.asarray(want.h, np.float64)
    scale = np.abs(want_h).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(n(got.h) - want_h) <= 1e-4 * scale)


def test_match_pair_at_16_words(ring16):
    """match_pair on 16-word descriptors gives the JAX package's match
    table, with the same key."""
    fa, fb = ring16[0], ring16[1]
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    want = jm.match_pair(jax.tree.map(jnp.asarray, fa),
                         jax.tree.map(jnp.asarray, fb), key)
    ta, tb = (features_from_numpy(f, device="cpu") for f in (fa, fb))
    assert ta.desc.shape == (400, 16)
    with checked_keys(0, 1):
        got = matching.match_pair(ta, tb, split(PRNGKey(0, "cpu"), 1)[0])
    assert int(got.num_inliers) > 8
    _assert_pair_equal(got, want)


def test_match_all_pairs_at_16_words(ring16):
    """The slice as a whole: match_all_pairs on the 16-word ring equals
    the JAX package's, pair for pair, with the same key."""
    stack = JFeatures(*(jnp.stack([jnp.asarray(getattr(f, name))
                                   for f in ring16]) for name in FIELDS))
    ref = jax.tree.map(np.asarray, jm.match_all_pairs(
        stack, jax.random.PRNGKey(0)))
    with checked_keys(0, 3) as drawn:
        got = matching.match_all_pairs(Features.stack(
            [features_from_numpy(f, device="cpu") for f in ring16]),
            PRNGKey(0, "cpu")).numpy()
    assert drawn[0] == 3
    for name in ("ii", "jj", "a_idx", "b_idx", "valid", "inlier",
                 "num_matches", "num_inliers"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_allclose(got.confidence, ref.confidence, rtol=0,
                               atol=1e-5)
    scale = np.abs(ref.h).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got.h - ref.h) <= 1e-4 * scale)
    assert got.num_inliers[0, 1] > 8


# The chunked kernel's shape (`csrc/hamming_chunked.cu`).
TILE = 128       # A rows a block, B columns a tile
DEPTH = 128      # bytes of depth a stage
CHUNKED_WORDS = (1, 3, 4, 5, 13, 16, 32)


def _pm1(words):
    """(..., W) uint32 -> (..., 32 W) int64 of +1 (bit 0) / -1 (bit 1),
    bit b of word w at 32 w + b."""
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return 1 - 2 * bits.reshape(*words.shape[:-1], -1).astype(np.int64)


def _chunked_walk(a_rows, b_rows, valid_b, words, shift=16):
    """One direction's 2-NN as the kernel walks it: the +-1 rows
    zero-filled to whole 128-byte stages and whole 128-row tiles; per
    column tile with a valid column (the others skipped), the dot products
    summed stage by stage; each becomes the key (32 W - dot) << (shift -
    1) | column (shift 16: 32-bit keys, 32: 64-bit ones), or all ones for
    an invalid column; a key enters the row's running top-2 only below
    the second's distance (columns come in increasing order).  Returns
    (i1, d1, i2, d2) and the number of tiles skipped."""
    k = a_rows.shape[0]
    r = 32 * words
    depth = -(-r // DEPTH) * DEPTH
    kp = -(-k // TILE) * TILE
    pa = np.zeros((kp, depth), np.int64)
    pb = np.zeros((kp, depth), np.int64)
    pa[:k, :r] = _pm1(a_rows)
    pb[:k, :r] = _pm1(b_rows)
    vb = np.zeros(kp, bool)
    vb[:k] = valid_b
    none = np.uint64((1 << 2 * shift) - 1)
    b1 = np.full(kp, none, np.uint64)
    b2 = np.full(kp, none, np.uint64)
    skipped = 0
    for c0 in range(0, kp, TILE):
        cols = np.arange(c0, c0 + TILE)
        if not vb[cols].any():
            skipped += 1
            continue
        acc = np.zeros((kp, TILE), np.int64)
        for s0 in range(0, depth, DEPTH):
            acc += pa[:, s0:s0 + DEPTH] @ pb[cols, s0:s0 + DEPTH].T
        assert np.all(np.abs(acc) <= r) and np.all((r - acc) % 2 == 0)
        keys = np.where(vb[cols], ((r - acc).astype(np.uint64) <<
                                   np.uint64(shift - 1)) |
                        cols.astype(np.uint64), none)
        sh = np.uint64(shift)
        keys = np.where((keys >> sh) < (b2 >> sh)[:, None], keys, none)
        top = np.sort(np.concatenate([b1[:, None], b2[:, None], keys], 1),
                      axis=1)
        b1, b2 = top[:, 0], top[:, 1]
    out = []
    for b in (b1[:k], b2[:k]):
        out += [np.where(b == none, 0, b & np.uint64((1 << shift) - 1)
                         ).astype(np.int64),
                np.where(b == none, BIG, b >> np.uint64(shift)
                         ).astype(np.float32)]
    return tuple(out), skipped


def _runs_valid(valid, run=30, block=150):
    """The stack's validity with only the first `run` columns of each
    `block`-column block kept: whole 128-column tiles invalid."""
    return valid & (np.arange(valid.shape[1]) % block < run)


@pytest.mark.parametrize("mask", ["stack", "runs"])
@pytest.mark.parametrize("words", CHUNKED_WORDS)
def test_chunked_walk_matches_reference(words, mask):
    """The chunked kernel's arithmetic, emulated, equals the JAX package's
    `_two_nn(hamming_matrix(...))` both ways, d exact and indices equal, at
    K = 300 (two whole tiles and a part) with the stack's ties, single- and
    zero-valid images, and (runs) all-invalid tiles skipped."""
    d, valid, iu, ju = _stack(words + 100, words, k=300)
    if mask == "runs":
        valid = _runs_valid(valid)
    want_f, want_r = _reference(d, valid, iu, ju)
    skipped = 0
    for want, pairs in ((want_f, zip(iu, ju)), (want_r, zip(ju, iu))):
        for p, (a, b) in enumerate(pairs):
            got, n_skip = _chunked_walk(d[a], d[b], valid[b], words)
            skipped += n_skip
            _assert_two_nn_equal(got, [w[p] for w in want])
    if mask == "runs":
        # Columns 256-299 hold no valid one in any image.
        assert skipped >= 2 * len(iu)
    assert (want_f[1] == want_f[3]).any()


@pytest.mark.parametrize("words", CHUNKED_WORDS)
def test_chunked_walk_wide_keys_match_reference(words):
    """The same walk on the 64-bit keys (d << 32 | column) that the kernel
    takes past K = 65536 or 2047 words equals the JAX reference, with the
    run-masked validity (all-invalid tiles skipped)."""
    d, valid, iu, ju = _stack(words + 200, words, k=300)
    valid = _runs_valid(valid)
    want_f, want_r = _reference(d, valid, iu, ju)
    for want, pairs in ((want_f, zip(iu, ju)), (want_r, zip(ju, iu))):
        for p, (a, b) in enumerate(pairs):
            got, _ = _chunked_walk(d[a], d[b], valid[b], words, shift=32)
            _assert_two_nn_equal(got, [w[p] for w in want])
    assert (want_f[1] == want_f[3]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["stack", "runs"])
@pytest.mark.parametrize("words", CHUNKED_WORDS + (8, 12))
def test_chunked_kernel_matches_plain_on_cuda(words, mask):
    dev = cuda_device()
    d, valid, iu, ju = _stack(words, words, n_img=4, k=1100)
    if mask == "runs":
        valid = _runs_valid(valid)
    args = _args(d, valid, iu, ju, dev)
    before = hamming_two_nn_pairs.launches
    got = hamming_two_nn_pairs(*args)
    torch.cuda.synchronize()
    assert hamming_two_nn_pairs.launches == before + 1
    want = hamming_two_nn_pairs_plain(*args)
    for g, w in zip(got, want):
        _assert_two_nn_equal(g, [n(x) for x in w])


def _rows_plain(desc, valid, ii, jj, rows):
    """The plain 2-NN of `rows` of each pair's A image, both directions,
    without the whole (K, K) matrix."""
    fwd, rev = [], []
    for a, b in zip(ii.tolist(), jj.tolist()):
        fwd.append(hamming_two_nn_plain(desc[a, rows], desc[b], valid[b]))
        rev.append(hamming_two_nn_plain(desc[b, rows], desc[a], valid[a]))
    return [tuple(torch.stack(x) for x in zip(*side)) for side in (fwd, rev)]


@pytest.mark.cuda
def test_chunked_route_limits_raise_on_cuda():
    """Past K = 65536 and past 2047 words the kernel takes 64-bit keys and
    equals its plain version (on slices of rows at K = 65537 and 70000
    whose nearest or second-nearest columns lie past 65535); more than 65535 pairs go in one call; a call raises only
    for W < 1 or past the shared-memory and TMA limits, naming them, and
    launches nothing then."""
    dev = cuda_device()
    rng = np.random.default_rng(7)
    pair = torch.zeros((1,), dtype=torch.int32, device=dev)
    for k in (65537, 70000):
        d = rng.integers(0, 2 ** 32, (2, k, 8), dtype=np.uint64).astype(
            np.uint32)
        # Rows 2 m + 1 of image 0 are rows 2 m with one bit flipped.
        d[0, 1:k:2] = d[0, 0:k - 1:2] ^ np.uint32(1 << 31)
        # Column c of image 1 is row c - (k - 256) (mod k) of image 0 with
        # a bit of each word flipped: image 0's rows 0-255 find their
        # nearest and second nearest among columns k - 256 to k - 1, and
        # image 1's rows 65280-65535 theirs among columns 65536 up of image
        # 0 (at K = 65537 column 65536 alone, for some of those rows).
        d[1] = np.roll(d[0], k - 256, axis=0) ^ (np.uint32(1) << (
            np.arange(k, dtype=np.uint32) % 32))[:, None]
        valid = rng.random((2, k)) > 0.1
        valid[:, 65280:] = True
        args = _args(d, valid, np.zeros(1, np.int32), np.ones(1, np.int32),
                     dev)
        before = hamming_two_nn_pairs.launches
        got = hamming_two_nn_pairs(*args)
        assert hamming_two_nn_pairs.launches == before + 1
        for rows in (slice(0, 256), slice(65280, 65536), slice(k - 256, k)):
            want = _rows_plain(*args, torch.arange(k, device=dev)[rows])
            for g, w in zip(got, want):
                _assert_two_nn_equal([x[:, rows] for x in g],
                                     [n(x) for x in w])
        for j in (0, 2):  # i1, i2
            assert any(bool((side[j][0, rows] >= 65536).any())
                       for side, rows in ((got[0], slice(0, 256)),
                                          (got[1], slice(65280, 65536)))), (
                k, j)
    for words in (2048, 4096):
        dw, vw, iu, ju = _stack(words, words, n_img=3, k=512)
        args = _args(dw, vw, iu, ju, dev)
        for g, w in zip(hamming_two_nn_pairs(*args),
                        hamming_two_nn_pairs_plain(*args)):
            _assert_two_nn_equal(g, [n(x) for x in w])
    # 363 images: 65703 pairs, past grid.y's 65535, in one call.
    dp = rng.integers(0, 2 ** 32, (363, 90, 1), dtype=np.uint64).astype(
        np.uint32)
    vp = rng.random((363, 90)) > 0.1
    iu, ju = (x.astype(np.int32) for x in np.triu_indices(363, 1))
    args = _args(dp, vp, iu, ju, dev)
    got = hamming_two_nn_pairs(*args)
    pick = np.r_[0:64, len(iu) - 64:len(iu)]
    want = hamming_two_nn_pairs_plain(*args[:2], *(a[pick] for a in args[2:]))
    for g, w in zip(got, want):
        _assert_two_nn_equal([x[pick] for x in g], [n(x) for x in w])
    before = hamming_two_nn_pairs.launches
    for shape, what in (((1, 4, 0), "1 or more"),
                        ((1, max_k(1, dev) + 1, 1), "shared memory")):
        with pytest.raises(ValueError, match=what):
            hamming_two_nn_pairs(
                torch.zeros(shape, dtype=torch.int32, device=dev),
                torch.ones(shape[:2], dtype=torch.bool, device=dev), pair,
                pair)
    assert hamming_two_nn_pairs.launches == before


# ---- the card at the stitch's shapes -------------------------------------

def _ring_stack(kind, words, k=4000, n_img=8, seed=0):
    """Stacks at the ring's K, every pair i < j: `random` (images 1..n-1
    near copies of image 0, each bit flipped with probability 0.05; 90%
    valid), `runs` (the same, valid only in the first 84 columns of each
    500, as ORB's per-level top-k leaves mosaic100's) and `ties` (4
    images: image 1 repeats rows of image 0, each twice, image 0 holds
    duplicates, image 2 has one valid descriptor, image 3 none).  `wide`
    is `random` with columns 2 r and 2 r + 1 of images 1..n-1 near copies
    of row r of image 0, so rows of image 0 from K / 4 up find their
    nearest columns past K / 2."""
    rng = np.random.default_rng(seed)
    n_img = 4 if kind == "ties" else n_img
    d = rng.integers(0, 2 ** 32, (n_img, k, words), dtype=np.uint64).astype(
        np.uint32)
    flips = np.packbits(rng.random((n_img - 1, k, words, 32),
                                   dtype=np.float32) < 0.05, axis=-1,
                        bitorder="little").view("<u4")[..., 0]
    valid = rng.random((n_img, k)) > 0.1
    if kind == "ties":
        d[0, k // 2:] = d[0, :k - k // 2]
        d[1] = d[0, rng.integers(0, k // 2, k)]
        valid[2] = False
        valid[2, k // 3] = True
        valid[3] = False
    elif kind == "wide":
        d[1:] = np.repeat(d[0, :k // 2], 2, axis=0) ^ flips
    else:
        d[1:] = d[0] ^ flips
    if kind == "runs":
        valid = np.broadcast_to(np.arange(k) % 500 < 84, valid.shape)
    iu, ju = (x.astype(np.int32) for x in np.triu_indices(n_img, 1))
    return d, np.ascontiguousarray(valid), iu, ju


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "runs", "ties"])
@pytest.mark.parametrize("words", CHUNKED_WORDS + (8, 12))
def test_kernel_at_ring_k_on_cuda(words, kind):
    """K4 at the ring's K = 4000 (28 pairs, both directions) on random,
    run-masked (whole column tiles skipped) and tie stacks, one launch,
    against its plain version: indices equal, distances exact."""
    dev = cuda_device()
    args = _args(*_ring_stack(kind, words, seed=words), dev)
    before = hamming_two_nn_pairs.launches
    got = hamming_two_nn_pairs(*args)
    assert hamming_two_nn_pairs.launches == before + 1
    for g, w in zip(got, hamming_two_nn_pairs_plain(*args)):
        _assert_two_nn_equal(g, [n(x) for x in w])


def _ring_features(dev):
    """The sigma-4 8 x 2448x3264 ring's full-resolution ORB features
    (tests/data/ring_sigma4_features.npz) on `dev`."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "ring_sigma4_features.npz"))
    zeros = torch.zeros(z["valid"].shape, device=dev)
    return Features(xy=torch.from_numpy(z["xy"]).to(dev), response=zeros,
                    angle=zeros, octave=zeros.to(torch.int32), size=zeros,
                    desc=torch.from_numpy(z["desc"]).to(dev),
                    valid=torch.from_numpy(z["valid"]).to(dev))


def _with_words(feats, words):
    """The features with their 8-word descriptors cut to the first
    `words` words, or widened by zero words, which change no distance."""
    desc = feats.desc[..., :words] if words <= 8 else torch.cat(
        [feats.desc, feats.desc.new_zeros(feats.desc.shape[:2] +
                                          (words - 8,))], -1)
    return dataclasses.replace(feats, desc=desc.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("words", (12,) + CHUNKED_WORDS)
def test_match_all_pairs_at_other_widths_on_cuda(words):
    """match_all_pairs on the ring's ORB features at W words, as the
    default stitch calls it: one K4 launch; widened by zero words, the
    match tables, inliers, homographies and confidences equal the 8-word
    call's; cut below 8 words, finite homographies."""
    from image_stitching_tpu_torch.config import StitchConfig
    dev = cuda_device()
    feats, cfg = _ring_features(dev), StitchConfig()

    def graph(w):
        before = hamming_two_nn_pairs.launches
        g = matching.match_all_pairs(_with_words(feats, w),
                                     PRNGKey(cfg.seed, dev),
                                     match_conf=cfg.match_conf,
                                     pair_cap=cfg.num_features)
        torch.cuda.synchronize()
        assert hamming_two_nn_pairs.launches == before + 1
        return g
    got, base = graph(words), graph(8)
    if words < 8:
        assert bool(torch.isfinite(got.h).all())
        return
    for name in ("ii", "jj", "a_idx", "b_idx", "valid", "inlier", "h",
                 "num_inliers", "confidence", "num_matches"):
        assert torch.equal(getattr(got, name), getattr(base, name)), name


def _rows_plain_blocks(desc, valid, ii, jj, block=8192):
    """`_rows_plain` on every row, by blocks."""
    k = desc.shape[1]
    parts = [_rows_plain(desc, valid, ii, jj,
                         torch.arange(s, min(s + block, k),
                                      device=desc.device))
             for s in range(0, k, block)]
    return [tuple(torch.cat(x, -1) for x in zip(*[p[side] for p in parts]))
            for side in (0, 1)]


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("kind", ["wide", "runs", "ties"])
def test_kernel_past_65535_columns_every_row_on_cuda(kind):
    """K = 70000 at 8 words (64-bit keys), 4 images, 6 pairs both ways,
    one launch, against the plain version on every row: indices equal,
    distances exact; the wide stack's nearest columns reach past 65535."""
    dev = cuda_device()
    args = _args(*_ring_stack(kind, 8, k=70000, n_img=4), dev)
    assert key_bits(70000, 8) == 64
    before = hamming_two_nn_pairs.launches
    got = hamming_two_nn_pairs(*args)
    assert hamming_two_nn_pairs.launches == before + 1
    want = _rows_plain_blocks(*args)
    for g, w in zip(got, want):
        _assert_two_nn_equal(g, [n(x) for x in w])
    if kind == "wide":
        assert bool((want[0][0][:, 32768:] >= 65536).any())


@pytest.mark.cuda
@pytest.mark.parametrize("words", [2048, 4096])
def test_kernel_distance_past_16_bits_on_cuda(words):
    """At 2048 and 4096 words (64-bit keys) a distance of 32 W, past 16
    bits: image 3 is all the complement of image 2's row 0."""
    dev = cuda_device()
    args = _args(*_ring_stack("wide", words, k=512, n_img=4, seed=words),
                 dev)
    args[0][3] = ~args[0][2, 0]
    before = hamming_two_nn_pairs.launches
    got = hamming_two_nn_pairs(*args)
    assert hamming_two_nn_pairs.launches == before + 1
    want = hamming_two_nn_pairs_plain(*args)
    for g, w in zip(got, want):
        _assert_two_nn_equal(g, [n(x) for x in w])
    assert float(want[0][1][5, 0]) == float(want[0][3][5, 0]) == 32 * words


@pytest.mark.cuda
def test_kernel_65703_pairs_in_one_launch_on_cuda():
    """363 images of K = 128 at 8 words: 65703 pairs, past grid.y's 65535,
    in one launch, against the plain version on 256 of them."""
    dev = cuda_device()
    args = _args(*_ring_stack("random", 8, k=128, n_img=363, seed=3), dev)
    n_pairs = len(args[2])
    assert n_pairs == 65703
    before = hamming_two_nn_pairs.launches
    got = hamming_two_nn_pairs(*args)
    assert hamming_two_nn_pairs.launches == before + 1
    pick = torch.as_tensor(np.r_[0:64, n_pairs - 64:n_pairs, np.random.
                                 default_rng(0).choice(n_pairs, 128, False)],
                           device=dev)
    want = hamming_two_nn_pairs_plain(args[0], args[1], args[2][pick],
                                      args[3][pick])
    for g, w in zip(got, want):
        _assert_two_nn_equal([x[pick] for x in g], [n(x) for x in w])


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["ring", "random 12 words"])
def test_unpack_equals_pm1_rows_on_cuda(source):
    """K4's +-1 unpack (the first of its two launches) equals `pm1_rows`
    on the ring's ORB descriptors and on 12-word (AKAZE's) ones."""
    dev = cuda_device()
    desc = (_ring_features(dev).desc if source == "ring" else
            _args(*_ring_stack("random", 12), dev)[0])
    assert torch.equal(unpack_pm1(desc), pm1_rows(desc))
