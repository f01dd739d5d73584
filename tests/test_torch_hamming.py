"""Port parity: kernel K4 (`hamming_two_nn_pairs`), the Hamming 2-NN of
every pair of an image stack in both match directions.

On the CPU the wrapper runs its plain version, which is what
`match_all_pairs` runs there.  The reference is the JAX package's live XLA
route, `match_pair`'s `_two_nn(hamming_matrix(a, b))` forward and `_two_nn`
of the transposed matrix in reverse: `hamming_two_nn_pallas` takes no
interpret flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, n, t
from image_stitching_tpu.ops import matching as jm
from image_stitching_tpu_torch.kernels.hamming import (
    hamming_matrix, hamming_two_nn_pairs, hamming_two_nn_pairs_plain,
    hamming_two_nn_plain, pm1_rows)

BIG = 2.0 ** 30


def _stack(seed, n_img=5, k=90):
    """An image stack of random 256-bit descriptors with exact duplicates
    (ties in both directions), invalid columns, one image with a single
    valid descriptor and one with none; and every pair i < j."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n_img, k, 8), dtype=np.uint64).astype(
        np.uint32)
    # Near copies of image 0 so the 2-NN distances are small and varied.
    flips = (rng.random((n_img - 1, 40, 8)) < 0.02).astype(np.uint32) << \
        rng.integers(0, 32, (n_img - 1, 40, 8)).astype(np.uint32)
    d[1:, :40] = d[0, :40] ^ flips
    d[1, 50] = d[1, 10]            # duplicate columns: a tie for row 10
    d[1, 61] = d[1, 10]
    d[0, 55] = d[0, 12]            # a duplicate row: a tie in reverse
    d[2, 70:80] = d[2, 70]         # a run of ten equal descriptors
    valid = rng.random((n_img, k)) > 0.15
    valid[1, 50] = valid[1, 61] = True
    valid[1, 10] = False           # the tie now sits at 50 and 61
    valid[n_img - 2] = False
    valid[n_img - 2, 33] = True    # one valid column
    valid[n_img - 1] = False       # none
    iu, ju = np.triu_indices(n_img, 1)
    return d, valid, iu.astype(np.int32), ju.astype(np.int32)


def _reference(d, valid, iu, ju):
    """Per pair: JAX forward and reverse 2-NN, as match_pair takes them."""
    fwd, rev = [], []
    for a, b in zip(iu, ju):
        dist = jm.hamming_matrix(jnp.asarray(d[a]), jnp.asarray(d[b])).astype(
            jnp.float32)
        fwd.append(jm._two_nn(dist, jnp.asarray(valid[b])))
        rev.append(jm._two_nn(dist.T, jnp.asarray(valid[a])))
    return ([np.stack([np.asarray(x[m]) for x in fwd]) for m in range(4)],
            [np.stack([np.asarray(x[m]) for x in rev]) for m in range(4)])


def _assert_two_nn_equal(got, want):
    """i1, d1, d2 equal; i2 equal wherever d2 < 2^30."""
    i1, d1, i2, d2 = (n(x) for x in got)
    np.testing.assert_array_equal(i1, want[0])
    np.testing.assert_array_equal(d1, want[1])
    np.testing.assert_array_equal(d2, want[3])
    real = want[3] < BIG
    np.testing.assert_array_equal(i2[real], want[2][real])
    assert d1.dtype == np.float32 and i1.dtype == np.int64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k4_plain_matches_reference_both_directions(seed):
    d, valid, iu, ju = _stack(seed)
    want_f, want_r = _reference(d, valid, iu, ju)
    got_f, got_r = hamming_two_nn_pairs(t(d.view(np.int32)), t(valid),
                                        t(iu), t(ju))
    _assert_two_nn_equal(got_f, want_f)
    _assert_two_nn_equal(got_r, want_r)
    # The single-direction plain 2-NN on the swapped pair gives the same
    # reverse 2-NN as the transposed matrix.
    desc, v = t(d.view(np.int32)), t(valid)
    a, b = t(iu).long(), t(ju).long()
    _assert_two_nn_equal(hamming_two_nn_plain(desc[a], desc[b], v[b]),
                         want_f)
    _assert_two_nn_equal(hamming_two_nn_plain(desc[b], desc[a], v[a]),
                         want_r)
    # The cases the data was built for did occur.
    none = ju == len(valid) - 1
    one = ju == len(valid) - 2
    assert np.all(want_f[1][none] == BIG)               # no valid column
    assert np.all(want_f[1][one] < BIG) and np.all(want_f[3][one] == BIG)
    assert (want_f[1][~none] == want_f[3][~none]).any()  # ties
    assert (want_r[1][iu == 0] == want_r[3][iu == 0]).any()
    assert (want_f[1] < 20).sum() > 80                  # near copies
    # Rows with no valid column: i1 = 0 like argmin.
    assert np.all(n(got_f[0])[none] == 0)


@pytest.mark.parametrize("chunk", [1, 2, 64])
def test_k4_plain_chunks_agree(chunk):
    """The plain version's pair chunks bound its memory, not its result."""
    d, valid, iu, ju = _stack(4)
    args = (t(d.view(np.int32)), t(valid), t(iu), t(ju))
    one = hamming_two_nn_pairs_plain(*args, chunk=len(iu))
    got = hamming_two_nn_pairs_plain(*args, chunk=chunk)
    for side_g, side_w in zip(got, one):
        for g, w in zip(side_g, side_w):
            assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 5])
def test_pm1_unpack_dot_is_hamming(seed):
    """(256 - <pm1(a), pm1(b)>) / 2 equals the Hamming matrix bit for bit
    (an int32 product on the CPU), the port's and the JAX package's."""
    d, _, _, _ = _stack(seed, n_img=3, k=90)
    a, b = t(d[0].view(np.int32)), t(d[1].view(np.int32))
    pa, pb = pm1_rows(a), pm1_rows(b)
    assert pa.dtype == torch.int8 and tuple(pa.shape) == (90, 256)
    assert set(torch.unique(pa).tolist()) == {-1, 1}
    dot = pa.to(torch.int32) @ pb.to(torch.int32).T
    assert bool(((256 - dot) % 2 == 0).all())
    got = (256 - dot) // 2
    np.testing.assert_array_equal(n(got), n(hamming_matrix(a, b)))
    np.testing.assert_array_equal(
        n(got), np.asarray(jm.hamming_matrix(jnp.asarray(d[0]),
                                             jnp.asarray(d[1]))))
    # Bit b of word w is byte 32 w + b: -1 where the bit is set.
    np.testing.assert_array_equal(
        n(pa[:, 37]), np.where((d[0][:, 1] >> 5) & 1, -1, 1))


def test_k4_wrapper_checks_inputs():
    d, valid, iu, ju = _stack(2, n_img=3)
    desc, v, ii, jj = t(d.view(np.int32)), t(valid), t(iu), t(ju)
    with pytest.raises(TypeError):
        hamming_two_nn_pairs(desc.long(), v, ii, jj)
    with pytest.raises(TypeError):
        hamming_two_nn_pairs(desc, v, ii.long(), jj)
    with pytest.raises(ValueError):
        hamming_two_nn_pairs(desc, v[:, :5], ii, jj)
    with pytest.raises(ValueError):
        hamming_two_nn_pairs(desc[..., :4], v, ii, jj)
    with pytest.raises(ValueError):
        hamming_two_nn_pairs(desc, v, ii, jj[:1])


def test_k4_plain_past_65536_descriptors():
    """More than 65536 descriptors an image (the JAX CLI's --num-features
    70000) pass the wrapper's checks, as they do in the JAX package: with
    no pair, empty (P, K) outputs of the right types."""
    k = 65537
    desc = torch.zeros((2, k, 1), dtype=torch.int32)
    valid = torch.ones((2, k), dtype=torch.bool)
    none = torch.zeros((0,), dtype=torch.int32)
    for side in hamming_two_nn_pairs(desc, valid, none, none):
        assert [tuple(x.shape) for x in side] == [(0, k)] * 4
        assert [x.dtype for x in side] == [torch.int64, torch.float32] * 2


@pytest.mark.cuda
def test_k4_kernel_matches_plain_on_cuda():
    dev = cuda_device()
    d, valid, iu, ju = _stack(3, n_img=4, k=1100)
    args = [t(x).to(dev) for x in (d.view(np.int32), valid, iu, ju)]
    before = hamming_two_nn_pairs.launches
    got = hamming_two_nn_pairs(*args)
    torch.cuda.synchronize()
    assert hamming_two_nn_pairs.launches == before + 1
    want = hamming_two_nn_pairs_plain(*args)
    for g, w in zip(got, want):
        _assert_two_nn_equal(g, [n(x) for x in w])
