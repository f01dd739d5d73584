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
    # atan2 of the skew and symmetric parts: arccos((tr - 1) / 2) loses
    # ~0.04 degree near 0 to float32 rotations' 1e-7 scale error.
    sin = np.linalg.norm([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                          m[1, 0] - m[0, 1]]) / 2
    return float(np.degrees(np.arctan2(sin, (np.trace(m) - 1) / 2)))


@contextlib.contextmanager
def checked_keys(seed: int, n_pairs: int):
    """Watch the port's RANSAC draw its own numbers: `match_all_pairs`
    draws through `ops/ransac.py::ransac_draws`, and pair p must take
    split(PRNGKey(seed), n_pairs)[p], the reference stitch's key, bit for
    bit; no call of `ransac_homography`/`ransac_affine_partial` takes
    injected indices.  The calls pass through unchanged.  Yields a
    one-element list counting the pairs drawn."""
    import jax
    from image_stitching_tpu_torch.ops import matching as tmatching
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                       n_pairs)).astype(np.int64)
    real = {name: getattr(tmatching, name) for name in (
        "ransac_draws", "ransac_homography", "ransac_affine_partial")}
    done = [0]

    def draws(key, *args, **kwargs):
        rows = n(key)
        assert np.array_equal(rows, want[done[0]:done[0] + len(rows)]), \
            f"pairs {done[0]}.. did not take the reference's keys"
        done[0] += len(rows)
        return real["ransac_draws"](key, *args, **kwargs)

    def no_injection(fn):
        def call(*args, **kwargs):
            assert kwargs.get("hyp_idx") is None, "draws were injected"
            return fn(*args, **kwargs)
        return call
    for name, fn in real.items():
        setattr(tmatching, name,
                draws if name == "ransac_draws" else no_injection(fn))
    try:
        yield done
    finally:
        for name, fn in real.items():
            setattr(tmatching, name, fn)


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
