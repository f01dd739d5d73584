"""Port parity of one pair's registration and of the dp pair batch:
`ops/matching.py`'s `match_pair` and `register_pair`, and
`parallel/batched.py::make_batched_register`.

The pairs are tests/test_distributed.py's: a noise base (numpy seed 42)
and its roll by (7, 5), here at 96x128 with 256 features and n_hyp 128.
Pair p takes the key split(PRNGKey(0), B)[p] in both packages (the
port's from `core/prng.py`), so the JAX and port results compare draw for
draw: feature indices, `valid`, `inlier` and `n_inliers` equal,
confidence within 1e-5, and H within rtol 1e-4 of its largest entry (the
float32 rounding of the IRLS refit, as tests/test_torch_matching.py holds
it).  The batch equals single `register_pair` calls with the same keys on
any dp mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_h_close, n
from image_stitching_tpu.ops import matching as jm
from image_stitching_tpu.ops.features.orb import (
    orb_detect_and_describe as j_orb)
from image_stitching_tpu.parallel import make_batched_register as j_batched
from image_stitching_tpu.parallel import make_mesh as j_make_mesh
from image_stitching_tpu_torch.core import prng
from image_stitching_tpu_torch.interop import features_from_numpy
from image_stitching_tpu_torch.ops import matching
from image_stitching_tpu_torch.parallel import make_mesh
from image_stitching_tpu_torch.parallel.batched import (
    make_batched_register, register_pairs_batched)

HW = (96, 128)
KW = dict(n_features=256, n_hyp=128)
B = 4
CPU = torch.device("cpu")


def _keys(seed=0, b=B):
    """split(PRNGKey(seed), b) of the port, checked against the JAX keys."""
    keys = prng.split(prng.PRNGKey(seed, CPU), b)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), b))
    assert np.array_equal(n(keys), want.astype(np.int64))
    return keys


def _pairs(b=B):
    rng = np.random.default_rng(42)
    base = rng.uniform(0, 255, (b,) + HW).astype(np.float32)
    return np.stack([base, np.roll(base, (7, 5), (1, 2))], axis=1)


def _assert_pair_equal(got, want):
    for name in ("a_idx", "b_idx", "valid", "inlier", "num_inliers"):
        assert np.array_equal(n(getattr(got, name)),
                              np.asarray(getattr(want, name))), name
    np.testing.assert_allclose(n(got.confidence), np.asarray(want.confidence),
                               rtol=0, atol=1e-5)
    assert_h_close(n(got.h), want.h)


@pytest.mark.parametrize("p", range(B))
def test_register_pair_matches_reference(p):
    """register_pair (both ORB detections and the match) on pair p."""
    pairs = _pairs()
    key = jax.random.split(jax.random.PRNGKey(0), B)[p]
    want = jm.register_pair(jnp.asarray(pairs[p, 0]),
                            jnp.asarray(pairs[p, 1]), key, **KW)
    got = matching.register_pair(torch.as_tensor(pairs[p, 0]),
                                 torch.as_tensor(pairs[p, 1]), _keys()[p],
                                 **KW)
    assert isinstance(got, matching.PairMatches)
    assert got.a_idx.shape == (2 * KW["n_features"],)
    assert int(got.num_inliers) > 20
    _assert_pair_equal(got, want)


@pytest.mark.parametrize("matcher_type", ["homography", "affine"])
def test_match_pair_matches_reference(matcher_type):
    """match_pair on the reference's ORB features of pair 0, with the same
    key."""
    pairs = _pairs()
    fa, fb = (j_orb(jnp.asarray(pairs[0, i]), n_features=256)
              for i in (0, 1))
    key = jax.random.split(jax.random.PRNGKey(0), B)[0]
    want = jm.match_pair(fa, fb, key, 0.32, matcher_type, 128)
    ta, tb = (features_from_numpy(jax.tree.map(np.asarray, f), device=CPU)
              for f in (fa, fb))
    got = matching.match_pair(ta, tb, _keys()[0], 0.32, matcher_type, 128)
    _assert_pair_equal(got, want)


def test_batched_register_matches_reference():
    """The dp batch against the reference's, both on 4 devices, with the
    keys split(PRNGKey(0), B)."""
    pairs = _pairs()
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    h_j, c_j, n_j = j_batched(j_make_mesh((4, 1), ("dp", "sp")), HW,
                              **KW)(jnp.asarray(pairs), keys)
    h, c, n_inl = make_batched_register(
        make_mesh((4, 1), devices=[CPU] * 4), HW, **KW)(pairs, _keys())
    assert np.array_equal(n(n_inl), np.asarray(n_j))
    assert int(n_inl.min()) > 20
    np.testing.assert_allclose(n(c), np.asarray(c_j), rtol=0, atol=1e-5)
    assert_h_close(n(h), np.asarray(h_j))


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_batched_register_equals_single_calls(dp):
    """On a dp mesh of 1, 2 or 4 devices, pair p with key k equals
    register_pair with k: the same draws, bit-equal results."""
    pairs = _pairs()
    keys = _keys(10)
    h, c, n_inl = make_batched_register(
        make_mesh((dp, 1), devices=[CPU] * dp), HW, **KW)(pairs, keys)
    assert h.shape == (B, 3, 3) and c.shape == (B,) and n_inl.shape == (B,)
    for p in range(B):
        one = matching.register_pair(torch.as_tensor(pairs[p, 0]),
                                     torch.as_tensor(pairs[p, 1]), keys[p],
                                     **KW)
        assert int(one.num_inliers) == int(n_inl[p])
        assert torch.equal(one.h, h[p]) and torch.equal(one.confidence, c[p])


def test_batched_register_shape_checks():
    """B must divide over the dp devices; the pairs must have the built
    size; the keys must be int64 (B, 2), never seeds; register_pairs_batched
    builds and runs once."""
    mesh = make_mesh((3, 1), devices=[CPU] * 3)
    fn = make_batched_register(mesh, HW, **KW)
    with pytest.raises(ValueError, match="does not divide"):
        fn(_pairs(), _keys())
    with pytest.raises(ValueError, match="built for"):
        fn(_pairs(3)[:, :, :64], _keys(0, 3))
    with pytest.raises(TypeError, match="int64 tensor"):
        fn(_pairs(3), np.arange(3))
    with pytest.raises(TypeError, match="int64 tensor"):
        fn(_pairs(3), _keys(0, 3).to(torch.int32))
    with pytest.raises(ValueError, match="expected"):
        fn(_pairs(3), _keys(0, 4))
    h, _, n_inl = register_pairs_batched(_pairs(3), _keys(0, 3), mesh, **KW)
    assert h.shape == (3, 3, 3) and int(n_inl.min()) > 20
