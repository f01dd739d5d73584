"""Port parity of ORB at full resolution: the JAX package's detector and
the port's plain one on the first 2448x3264 view of DEFAULT_RING (sigma-8
noise), 4000 features, the default path's shape.  tests/test_torch_orb.py
holds the same detector at 160x224."""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import n
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops.features import orb as jorb
from image_stitching_tpu_torch.data import synth
from image_stitching_tpu_torch.ops.features import orb as torb


def _bits(words):
    w = np.asarray(words).astype(np.uint32)
    return (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1


def test_orb_full_resolution_default_ring_capture():
    """Keypoints equal: the same 4000 valid, octaves equal, positions
    within 1e-3 px.  Descriptors bit-equal but for a few bits: the
    intensity-centroid moments are float32 sums over the disk in another
    order than XLA's, so angles differ by up to ~4e-5 rad, which moves a
    rotated sample pair across a pixel boundary now and then (measured:
    3 bits in 3 of the 4000 descriptors, all at keypoints whose positions
    are bit-equal).  Held: angles within 1e-4 rad, at most 2 bits a
    descriptor, at most 1e-5 of all bits."""
    hw = synth.DEFAULT_RING["hw"]
    k, rs = synth.ring_geometry(synth.DEFAULT_RING["n_images"], hw,
                                synth.DEFAULT_RING["fov_deg"],
                                synth.DEFAULT_RING["overlap_ratio"])
    view = synth._render_noisy((0, k, rs[0], hw, synth.DEFAULT_RING["seed"],
                                synth.DEFAULT_RING["noise_sigma"]))
    gray = np.asarray(jimg.rgb_to_gray(jnp.asarray(
        np.round(view).astype(np.uint8))))
    ref = jorb.orb_detect_and_describe(jnp.asarray(gray), n_features=4000)
    got = torb.orb_detect_and_describe(torch.from_numpy(gray.copy()),
                                       n_features=4000)
    valid = np.asarray(ref.valid)
    assert valid.sum() == 4000
    np.testing.assert_array_equal(n(got.valid), valid)
    np.testing.assert_array_equal(n(got.octave), np.asarray(ref.octave))
    assert np.abs(n(got.xy) - np.asarray(ref.xy)).max() <= 1e-3
    assert np.abs(n(got.angle) - np.asarray(ref.angle)).max() <= 1e-4
    flips = (_bits(n(got.desc).view(np.uint32)) !=
             _bits(ref.desc)).reshape(4000, -1).sum(-1)
    assert flips.max() <= 2
    assert flips.sum() <= 1e-5 * flips.size * 256
