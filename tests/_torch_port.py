"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and go through the JAX
reference on the CPU (as its own tests run it) and through the port on CPU
tensors.  torch gets one thread: the suite runs under several xdist
workers, and torch's default thread count would oversubscribe the cores.
"""

import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def t(a, dtype=None):
    """numpy (or jax) array -> CPU torch tensor (a copy)."""
    arr = np.array(a, copy=True)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.as_tensor(arr, dtype=dtype)


def n(x):
    """torch tensor or array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cuda_device():
    """The CUDA device for tests marked `cuda`; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def rel_rotation_deg(ra, rb) -> float:
    """Angle (degrees) of ra @ rb^T."""
    m = np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(m) - 1) / 2,
                                              -1.0, 1.0))))


@contextlib.contextmanager
def reference_draws(seed: int, n_pairs: int):
    """Inject the reference's RANSAC draws into the port's stitch: pair p
    of `match_all_pairs` takes the hypothesis (and, for the homography,
    scoring) indices that the reference's stitch draws from
    split(PRNGKey(seed), n_pairs)[p]: 4 distinct points a hypothesis and
    a scoring subsample for the homography matcher, 2 distinct points for
    the affine one (`tests/test_torch_matching.py` and
    `tests/test_torch_registration.py` hold RANSAC equal given them).
    The comparisons then see the rest of the path alone: on 160x224
    captures an adjacent pair has only ~14 inliers, and other draws pick
    another equally good inlier set, which moves BA by ~0.1 degree.
    Yields a one-element list counting the pairs drawn."""
    import jax
    import jax.numpy as jnp
    from image_stitching_tpu.ops import ransac as jransac
    from image_stitching_tpu_torch.ops import matching as tmatching
    keys = jax.random.split(jax.random.PRNGKey(seed), n_pairs)
    real_h = tmatching.ransac_homography
    real_a = tmatching.ransac_affine_partial
    done = [0]

    def draws(valid, n_hyp, k):
        hyps, subs = [], []
        for row in n(valid):
            key = keys[done[0]]
            done[0] += 1
            v = jnp.asarray(row)
            hyps.append(np.asarray(jransac._sample_valid_distinct(
                key, v, n_hyp, k)))
            subs.append(np.asarray(jransac._sample_valid(
                jax.random.fold_in(key, 1), v, (min(v.shape[0], 1024),))))
        return t(np.stack(hyps)).long(), t(np.stack(subs)).long()

    def homography(src, dst, valid, generator=None, n_hyp=512, hyp_idx=None,
                   score_idx=None):
        hyp, sub = draws(valid, n_hyp, 4)
        return real_h(src, dst, valid, generator, n_hyp=n_hyp, hyp_idx=hyp,
                      score_idx=sub)

    def affine(src, dst, valid, generator=None, n_hyp=512, hyp_idx=None):
        hyp, _ = draws(valid, n_hyp, 2)
        return real_a(src, dst, valid, generator, n_hyp=n_hyp, hyp_idx=hyp)
    tmatching.ransac_homography = homography
    tmatching.ransac_affine_partial = affine
    try:
        yield done
    finally:
        tmatching.ransac_homography = real_h
        tmatching.ransac_affine_partial = real_a


def write_mixed_ring(directory, hws, fov_deg=55.0, overlap_ratio=0.6,
                     seed=7, noise_sigma=4.0):
    """A horizontal ring whose view i is rendered at its own size hws[i]
    with its own K (the same horizontal field of view), sigma-4 sensor
    noise drawn in view order from `seed`, stored rotated 180 degrees as
    JPEGs with each view's EXIF pose payload.  Returns ([K float64],
    [R float64])."""
    import os
    from image_stitching_tpu_torch.core import exif, image_io
    from image_stitching_tpu_torch.data.synth import (ring_geometry,
                                                      render_view)
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    ks, rs_out = [], []
    for i, hw in enumerate(hws):
        k, rs = ring_geometry(len(hws), hw, fov_deg, overlap_ratio)
        view = render_view(k, rs[i], hw, seed)
        img = np.clip(view + rng.normal(0.0, noise_sigma, view.shape).astype(
            np.float32), 0.0, 255.0)
        r32 = rs[i].astype(np.float32)
        payload = exif.camera_to_image_description(
            focal=float(k[1, 1]), ppx=float(k[0, 2]), ppy=float(k[1, 2]),
            R=r32, is_portrait=False)
        image_io.write_jpeg_with_description(
            os.path.join(directory, f"{i}.jpg"),
            image_io.rotate_180(img.astype(np.uint8)), payload, quality=92)
        ks.append(k)
        rs_out.append(r32.astype(np.float64))
    return ks, rs_out
