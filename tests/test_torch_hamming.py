"""Port parity: kernel K4 (`hamming_two_nn`), the Hamming 2-NN of both
match directions.

On the CPU the wrapper runs its plain version, which is what `match_pairs`
runs there.  The reference is the JAX package's live XLA route
(`_two_nn_hamming`, and `match_pair`'s reverse 2-NN over the transposed
matrix): `hamming_two_nn_pallas` takes no interpret flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, n, t
from image_stitching_tpu.ops import matching as jm
from image_stitching_tpu_torch.kernels.hamming import (hamming_two_nn,
                                                       hamming_two_nn_plain)

BIG = 2.0 ** 30


def _pairs(seed, p=4, ka=70, kb=90):
    """P pairs of random 256-bit descriptors with exact duplicates (ties
    in both directions), invalid columns on either side, and one pair
    whose B side is all invalid."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (p, ka, 8), dtype=np.uint64).astype(
        np.uint32)
    b = rng.integers(0, 2 ** 32, (p, kb, 8), dtype=np.uint64).astype(
        np.uint32)
    # Near copies so the 2-NN distances are small and varied.
    b[:, :40] = a[:, :40] ^ (rng.random((p, 40, 8)) < 0.02).astype(
        np.uint32) << rng.integers(0, 32, (p, 40, 8)).astype(np.uint32)
    b[:, 50] = b[:, 10]            # a B duplicate: tie for A row 10
    b[:, 61] = b[:, 10]
    a[:, 55] = a[:, 12]            # an A duplicate: tie in reverse
    va = rng.random((p, ka)) > 0.15
    vb = rng.random((p, kb)) > 0.15
    vb[:, 50] = True
    vb[:, 10] = False              # the tie now sits at 50 and 61
    vb[p - 1] = False              # all-invalid B side
    va[p - 1, :3] = False
    return a, b, va, vb


def _reference(a, b, va, vb):
    """Per pair: JAX forward (_two_nn_hamming) and reverse (match_pair's
    _two_nn over the transposed matrix)."""
    fwd, rev = [], []
    for k in range(a.shape[0]):
        fwd.append(jm._two_nn_hamming(jnp.asarray(a[k]), jnp.asarray(b[k]),
                                      jnp.asarray(vb[k])))
        dist = jm.hamming_matrix(jnp.asarray(a[k]), jnp.asarray(b[k]))
        rev.append(jm._two_nn(dist.astype(jnp.float32).T,
                              jnp.asarray(va[k])))
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


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_plain_matches_reference_both_directions(seed):
    a, b, va, vb = _pairs(seed)
    want_f, want_r = _reference(a, b, va, vb)
    got_f = hamming_two_nn(t(a), t(b), t(vb))
    got_r = hamming_two_nn(t(b), t(a), t(va))
    _assert_two_nn_equal(got_f, want_f)
    _assert_two_nn_equal(got_r, want_r)
    # The cases the data was built for did occur.
    assert np.all(want_f[1][-1] == BIG)                 # all-invalid side
    assert (want_f[1][:-1] == want_f[3][:-1]).any()     # ties
    assert (want_f[1][:-1] < 20).sum() > 50             # near copies
    # The all-invalid row: i1 = 0 like argmin; i2 as the plain version.
    assert np.all(n(got_f[0])[-1] == 0)


def test_k4_wrapper_checks_inputs():
    a, b, va, vb = _pairs(2, p=2)
    with pytest.raises(TypeError):
        hamming_two_nn(t(a).long(), t(b), t(vb))
    with pytest.raises(ValueError):
        hamming_two_nn(t(a), t(b)[:1], t(vb)[:1])
    with pytest.raises(ValueError):
        hamming_two_nn(t(a), t(b), t(vb)[:, :5])
    with pytest.raises(ValueError):
        hamming_two_nn(t(a)[..., :4], t(b), t(vb))


@pytest.mark.cuda
def test_k4_kernel_matches_plain_on_cuda():
    dev = cuda_device()
    a, b, va, vb = _pairs(3, p=3, ka=1000, kb=1100)
    args = [t(x).to(dev) for x in (a, b, vb)]
    before = hamming_two_nn.launches
    got = hamming_two_nn(*args)
    torch.cuda.synchronize()
    assert hamming_two_nn.launches == before + 1
    want = [n(x) for x in hamming_two_nn_plain(*args)]
    _assert_two_nn_equal(got, want)
