"""Port parity of `core/prng.py`, the port's copy of `jax.random`'s threefry
draws, and of RANSAC driven by it.

PRNGKey, split, fold_in and uniform equal jax.random's bit for bit, with
the keys batched as the stitch batches them (split(PRNGKey(seed), n_pairs)
then uniform under every pair's key at once, as the reference draws them
under vmap); a hypothesis property does the same over random keys and
shapes.  `ransac_homography` and `ransac_affine_partial` with a key give
the JAX functions' hypothesis indices, inlier masks and n_inliers for the
same key, and H within rtol 1e-4 of its largest entry (the float32
rounding of the IRLS refit, tests/test_torch_matching.py's bound).
`chip_smoke.py`'s golden values are pinned here from jax.  On a card the
port's draws equal its CPU draws (marked `cuda`).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_port import cuda_device, n, t
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.ops import ransac as jr
from image_stitching_tpu_torch.core import prng
from image_stitching_tpu_torch.ops import ransac

CPU = torch.device("cpu")
SEED = JConfig().seed
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(x) -> np.ndarray:
    """Keys (uint32 or int64) or float32 draws -> their uint32 words."""
    a = np.asarray(n(x))
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a.astype(np.int64).astype(np.uint32)


def _assert_bits_equal(got, want):
    assert np.asarray(n(got)).dtype in (np.int64, np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_jax_threefry_partitionable_is_the_default():
    """The port follows the partitionable counters; a jax whose default
    differs would draw other numbers, and fails here by name."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1])
def test_prng_key(seed):
    key = prng.PRNGKey(seed, CPU)
    assert key.dtype == torch.int64 and key.shape == (2,)
    _assert_bits_equal(key, jax.random.PRNGKey(seed))


def test_prng_key_refuses_what_is_no_32_bit_seed():
    """numpy and 0-d tensor integers are seeds; floats and seeds outside
    32 bits raise."""
    _assert_bits_equal(prng.PRNGKey(np.int32(-1), CPU),
                       jax.random.PRNGKey(-1))
    _assert_bits_equal(prng.PRNGKey(torch.tensor(42), CPU),
                       jax.random.PRNGKey(42))
    for bad in (1.5, torch.tensor(1.0), np.float32(2.0)):
        with pytest.raises(TypeError):
            prng.PRNGKey(bad, CPU)
    for bad in (2 ** 32, -2 ** 31 - 1):
        with pytest.raises(ValueError, match="not a 32-bit integer"):
            prng.PRNGKey(bad, CPU)


@pytest.mark.parametrize("num", [1, 2, 3, 28, 666])
def test_split(num):
    """split(PRNGKey(seed), num) as the stitch makes its pairs' keys, and
    split of a batch of keys (the reference under vmap)."""
    _assert_bits_equal(prng.split(prng.PRNGKey(SEED, CPU), num),
                       jax.random.split(jax.random.PRNGKey(SEED), num))
    base = jax.random.split(jax.random.PRNGKey(42), 3)
    _assert_bits_equal(
        prng.split(prng.split(prng.PRNGKey(42, CPU), 3), num),
        jax.vmap(lambda k: jax.random.split(k, num))(base))


@pytest.mark.parametrize("data", [0, 1, 2 ** 32 - 1])
def test_fold_in(data):
    """fold_in of one key and of the 28 keys of a ring's pairs; also
    split(k, n)[1] == fold_in(k, 1), the partitionable counters."""
    key = prng.PRNGKey(SEED, CPU)
    _assert_bits_equal(prng.fold_in(key, data),
                       jax.random.fold_in(jax.random.PRNGKey(SEED), data))
    keys = prng.split(key, 28)
    jkeys = jax.random.split(jax.random.PRNGKey(SEED), 28)
    _assert_bits_equal(prng.fold_in(keys, data),
                       jax.vmap(lambda k: jax.random.fold_in(k, data))(jkeys))
    assert torch.equal(prng.split(key, 3)[1], prng.fold_in(key, 1))


@pytest.mark.parametrize("shape", [(1,), (3,), (512, 4), (1024,), (7, 5, 3)])
def test_uniform(shape):
    """uniform under the 28 pair keys of a ring at once (the reference
    draws it under vmap), and under fold_in(key, 1) (its scoring draw)."""
    keys = prng.split(prng.PRNGKey(SEED, CPU), 28)
    jkeys = jax.random.split(jax.random.PRNGKey(SEED), 28)
    got = prng.uniform(keys, shape)
    assert got.dtype == torch.float32 and got.shape == (28,) + shape
    _assert_bits_equal(got, jax.vmap(
        lambda k: jax.random.uniform(k, shape))(jkeys))
    _assert_bits_equal(prng.uniform(prng.fold_in(keys, 1), shape), jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, 1), shape))(jkeys))
    _assert_bits_equal(prng.uniform(keys[5], shape),
                       jax.random.uniform(jkeys[5], shape))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@settings(max_examples=20, deadline=None, derandomize=True)
@given(seed=st.integers(-2 ** 31, 2 ** 31 - 1),
       num=st.integers(1, 40),
       data=st.integers(0, 2 ** 32 - 1),
       shape=st.lists(st.integers(1, 9), min_size=1, max_size=3))
def test_threefry_property(seed, num, data, shape):
    """Any 32-bit seed, split count, fold_in datum and shape: the same
    bits as jax.random."""
    shape = tuple(shape)
    keys = prng.split(prng.PRNGKey(seed, CPU), num)
    jkeys = jax.random.split(jax.random.PRNGKey(seed), num)
    _assert_bits_equal(keys, jkeys)
    _assert_bits_equal(prng.fold_in(keys, data), jax.vmap(
        lambda k: jax.random.fold_in(k, data))(jkeys))
    _assert_bits_equal(prng.uniform(keys, shape), jax.vmap(
        lambda k: jax.random.uniform(k, shape))(jkeys))


def test_keys_of_the_wrong_kind_raise():
    """A key is an int64 (..., 2) tensor; nothing is converted quietly."""
    key = prng.PRNGKey(0, CPU)
    for bad in (0, np.zeros(2, np.int64), key.to(torch.int32),
                key.to(torch.float64)):
        with pytest.raises(TypeError, match="int64 tensor"):
            prng.uniform(bad, (3,))
    for bad in (key[:1], key[None, :, None],
                torch.zeros((), dtype=torch.int64)):
        with pytest.raises(ValueError, match="shape"):
            prng.split(bad, 2)
    with pytest.raises(ValueError, match="not a uint32"):
        prng.fold_in(key, -1)
    src = torch.zeros((2, 10, 2))
    valid = torch.ones((2, 10), dtype=torch.bool)
    with pytest.raises(ValueError, match=r"expected \(2, 2\)"):
        ransac.ransac_homography(src, src, valid, prng.split(key, 3))
    with pytest.raises(ValueError, match="needs the pairs' keys"):
        ransac.ransac_affine_partial(src, src, valid)
    draws = ransac.ransac_draws(prng.split(key, 2), 512, 4, 10)
    assert draws[0].shape == (2, 512, 4) and draws[1].shape == (2, 10)
    with pytest.raises(ValueError, match="draws of shapes"):
        ransac.ransac_homography(src, src, valid, draws=(draws[0][:1],
                                                         draws[1]))
    with pytest.raises(ValueError, match="draws of shapes"):
        ransac.ransac_affine_partial(src, src, valid, draws=draws)


def _homography_case(seed, m):
    """Correspondences under a mild homography, 20% outliers, 5% invalid."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 400, (m, 2)).astype(np.float32)
    h_true = np.array([[1.02, 0.03, 40.0], [-0.02, 0.99, -12.0],
                       [1e-5, -2e-5, 1.0]])
    q = np.c_[src, np.ones(m)] @ h_true.T
    dst = (q[:, :2] / q[:, 2:]).astype(np.float32)
    dst += rng.normal(0, 0.5, dst.shape).astype(np.float32)
    dst[: m // 5] = rng.uniform(0, 400, (m // 5, 2))
    valid = rng.random(m) > 0.05
    return src, dst, valid


def _similarity_case(seed, m):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 400, (m, 2)).astype(np.float32)
    ang, s = 0.08, 1.03
    h_true = np.array([[s * np.cos(ang), -s * np.sin(ang), 25.0],
                       [s * np.sin(ang), s * np.cos(ang), -9.0], [0, 0, 1]])
    dst = (np.c_[src, np.ones(m)] @ h_true.T)[:, :2].astype(np.float32)
    dst += rng.normal(0, 0.5, dst.shape).astype(np.float32)
    dst[: m // 5] = rng.uniform(0, 400, (m // 5, 2))
    valid = rng.random(m) > 0.05
    return src, dst, valid


def _h_close(got, want):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("m", [300, 1500])
def test_ransac_homography_with_a_key(m):
    """Three pairs in one call, pair p with split(PRNGKey(3), 3)[p],
    against the JAX ransac_homography with that key: the hypothesis and
    scoring indices it draws (`_sample_valid_distinct`, `_sample_valid`
    of fold_in(key, 1); at M = 1500 the scoring subsample is 1024 of
    them), the inlier masks and n_inliers equal, H within rtol 1e-4."""
    cases = [_homography_case(s, m) for s in (1, 2, 3)]
    src, dst, valid = (np.stack(x) for x in zip(*cases))
    keys = prng.split(prng.PRNGKey(3, CPU), 3)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 3)
    h, mask, cnt = ransac.ransac_homography(t(src), t(dst), t(valid), keys)
    m_score = min(m, 1024)
    hyp = ransac.sample_valid_distinct(prng.uniform(keys, (512, 4)),
                                       t(valid))
    sub = ransac.sample_valid(
        prng.uniform(prng.fold_in(keys, 1), (m_score,)), t(valid))
    for p in range(3):
        v = jnp.asarray(valid[p])
        np.testing.assert_array_equal(
            n(hyp[p]), np.asarray(jr._sample_valid_distinct(jkeys[p], v, 512,
                                                            4)))
        np.testing.assert_array_equal(
            n(sub[p]), np.asarray(jr._sample_valid(
                jax.random.fold_in(jkeys[p], 1), v, (m_score,))))
        h_ref, mask_ref, n_ref = jr.ransac_homography(
            jnp.asarray(src[p]), jnp.asarray(dst[p]), v, jkeys[p])
        assert int(cnt[p]) == int(n_ref) > m // 2
        np.testing.assert_array_equal(n(mask[p]), np.asarray(mask_ref))
        _h_close(n(h[p]), h_ref)
    # The injected indices give the same result as the key's own draws.
    h2, mask2, cnt2 = ransac.ransac_homography(
        t(src), t(dst), t(valid), hyp_idx=hyp, score_idx=sub)
    assert torch.equal(mask2, mask) and torch.equal(cnt2, cnt)


def test_ransac_affine_partial_with_a_key():
    """Two similarity pairs with split(PRNGKey(5), 2) against the JAX
    ransac_affine_partial: the 2-point hypotheses, inlier masks and
    n_inliers equal, H within rtol 1e-4."""
    cases = [_similarity_case(s, 300) for s in (5, 6)]
    src, dst, valid = (np.stack(x) for x in zip(*cases))
    keys = prng.split(prng.PRNGKey(5, CPU), 2)
    jkeys = jax.random.split(jax.random.PRNGKey(5), 2)
    h, mask, cnt = ransac.ransac_affine_partial(t(src), t(dst), t(valid),
                                                keys)
    hyp = ransac.sample_valid_distinct(prng.uniform(keys, (512, 2)),
                                       t(valid))
    for p in range(2):
        v = jnp.asarray(valid[p])
        np.testing.assert_array_equal(
            n(hyp[p]), np.asarray(jr._sample_valid_distinct(jkeys[p], v, 512,
                                                            2)))
        h_ref, mask_ref, n_ref = jr.ransac_affine_partial(
            jnp.asarray(src[p]), jnp.asarray(dst[p]), v, jkeys[p])
        assert int(cnt[p]) == int(n_ref) > 200
        np.testing.assert_array_equal(n(mask[p]), np.asarray(mask_ref))
        _h_close(n(h[p]), h_ref)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_golden_values_are_jax_draws():
    """The uint32 words `chip_smoke.py` holds the card's draws to are
    jax.random's: split(PRNGKey(0), n) for n = 28 and 666, uniform
    (512, 4) under each key and (1024,) under fold_in(key, 1); the port's
    CPU draws (`prng_draws`) give them too."""
    smoke = _chip_smoke()
    draws = smoke.prng_draws(CPU)
    assert smoke.check_prng_golden(draws) == len(smoke.PRNG_GOLDEN)
    for name, index, word in smoke.PRNG_GOLDEN:
        kind, count = name.split("_")
        jkeys = jax.random.split(jax.random.PRNGKey(0), int(count))
        if kind == "split":
            want = np.asarray(jkeys)
        elif kind == "hyp":
            want = np.asarray(jax.vmap(
                lambda k: jax.random.uniform(k, (512, 4)))(jkeys))
        else:
            want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
                jax.random.fold_in(k, 1), (1024,)))(jkeys))
        assert int(_bits(want)[index]) == word, (name, index)


@pytest.mark.cuda
def test_draws_on_cuda_equal_the_cpu():
    """The port's draws on the card equal its CPU draws bit for bit: a
    stitch's worth (chip_smoke.py's `prng_draws`) and RANSAC's indices."""
    dev = cuda_device()
    smoke = _chip_smoke()
    got, want = smoke.prng_draws(dev), smoke.prng_draws(CPU)
    for name in want:
        assert got[name].device.type == "cuda"
        assert torch.equal(got[name].cpu(), want[name]), name
    assert smoke.check_prng_golden(got) == len(smoke.PRNG_GOLDEN)
    valid = t(np.stack([_homography_case(s, 1500)[2] for s in (1, 2)]))
    keys = prng.split(prng.PRNGKey(3, CPU), 2)
    for device in (CPU, dev):
        k, v = keys.to(device), valid.to(device)
        hyp = ransac.sample_valid_distinct(prng.uniform(k, (512, 4)), v)
        sub = ransac.sample_valid(prng.uniform(prng.fold_in(k, 1), (1024,)),
                                  v)
        if device == CPU:
            want = (hyp, sub)
    assert torch.equal(hyp.cpu(), want[0]) and torch.equal(sub.cpu(), want[1])
