"""Synthetic captures with ground-truth K/R and EXIF pose payloads.

Port, in numpy, of what `image_stitching_tpu/data/synth.py:117
make_ring_captures`, `:149 make_rig_captures` and `:177 write_capture_dir`
reach: a procedural sphere texture seen through known cameras (ray =
R K^-1 p), written as JPEGs whose ImageDescription carries the rig's pose
payload, so the whole ingestion path runs, or as plain JPEGs without one.
The formulas and the random-number call sequence are the reference's, so
one seed renders the same scene in both packages.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import exif as exif_mod
from ..core import image_io
from ..core.rig import DEFAULT_RIG, CaptureRig
from ..geometry.euler import euler_to_rotation_matrix

__all__ = ["sphere_texture_rgb", "render_view", "ring_geometry",
           "make_ring_captures", "make_rig_captures", "E2E_RING",
           "DEFAULT_RING", "ring_view_noise", "write_ring_dir",
           "write_capture_dir"]


def sphere_texture_rgb(lon: np.ndarray, lat: np.ndarray,
                       seed: int = 7, detail: bool = False) -> np.ndarray:
    """Trig base layers, 400 sharp lon/lat boxes and three octaves of cell
    noise, as float32 0..255 RGB.  With `detail` the base is compressed
    into [0.15, 0.85] first, so the cell octaves survive where it
    saturates (narrow-fov captures need them)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(lon.shape + (3,), np.float32)
    for c in range(3):
        acc = np.zeros_like(lon, np.float32)
        for _ in range(6):
            fl = rng.integers(1, 9)
            fm = rng.integers(1, 9)
            ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
            acc += rng.uniform(0.3, 1.0) * np.sin(fl * lon + ph1) * \
                np.cos(fm * lat + ph2)
        acc = (acc - acc.min()) / max(acc.max() - acc.min(), 1e-6)
        out[..., c] = acc
    # Boxes are evaluated only on the rows whose latitude range can meet
    # them; the rng call sequence is unchanged by that.
    row_lo = lat.min(axis=-1)
    row_hi = lat.max(axis=-1)
    for _ in range(400):
        lo = rng.uniform(-np.pi, np.pi)
        la = rng.uniform(-1.35, 1.15)
        dlo = rng.uniform(0.02, 0.22)
        dla = rng.uniform(0.02, 0.16)
        color = rng.uniform(-0.9, 0.9, 3).astype(np.float32)
        cand = np.nonzero((row_hi >= la) & (row_lo < la + dla))[0]
        if cand.size == 0:
            continue
        r0, r1 = int(cand[0]), int(cand[-1]) + 1
        sublon = lon[r0:r1]
        sublat = lat[r0:r1]
        dlon = np.mod(sublon - lo + np.pi, 2 * np.pi) - np.pi
        box = (dlon >= 0) & (dlon < dlo) & (sublat >= la) & \
            (sublat < la + dla)
        out[r0:r1][box] += color

    def cell_hash(u, v, salt):
        s = np.sin(u * 127.1 + v * 311.7 + salt) * 43758.547
        return (s - np.floor(s)).astype(np.float32)
    if detail:
        out = np.clip(out, 0.0, 1.0) * 0.7 + 0.15
    for amp, scale in ((0.22, 60.0), (0.15, 220.0), (0.12, 800.0)):
        cu = np.floor(lon * scale)
        cv = np.floor(lat * scale)
        for c in range(3):
            out[..., c] += amp * (cell_hash(cu, cv, 17.0 * c + 1.0) - 0.5)
    out = np.clip(out, 0.0, 1.0)
    return (out * 255.0).astype(np.float32)


def render_view(k, r, hw: Tuple[int, int], seed: int = 7,
                detail: bool = False) -> np.ndarray:
    """The sphere texture seen by camera (k, r) at size hw = (h, w)."""
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64) + 0.0
    pts = np.stack([xs, ys, np.ones_like(xs)], -1)
    rk = np.asarray(r, np.float64) @ np.linalg.inv(np.asarray(k, np.float64))
    rays = pts @ rk.T
    norm = np.linalg.norm(rays, axis=-1)
    lon = np.arctan2(rays[..., 0], rays[..., 2])
    lat = np.arcsin(np.clip(rays[..., 1] / np.maximum(norm, 1e-12), -1, 1))
    return sphere_texture_rgb(lon.astype(np.float32), lat.astype(np.float32),
                              seed, detail)


def _intrinsics(hw: Tuple[int, int], fov_deg: float) -> np.ndarray:
    """K (float64) of a centred camera with horizontal field fov_deg."""
    h, w = hw
    focal = (w / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
    return np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]],
                    np.float64)


def ring_geometry(n_images: int, hw: Tuple[int, int], fov_deg: float,
                  overlap_ratio: float, pitch_deg: float = 0.0):
    """(K float64, [R float64]) of a horizontal ring: consecutive yaw step
    fov * (1 - overlap_ratio)."""
    step = math.radians(fov_deg) * (1.0 - overlap_ratio)
    rs = []
    for i in range(n_images):
        eul = np.array([math.radians(pitch_deg), i * step, 0.0], np.float32)
        rs.append(np.asarray(euler_to_rotation_matrix(eul, "YXZ"),
                             np.float64))
    return _intrinsics(hw, fov_deg), rs


def _render_args(args) -> np.ndarray:
    return render_view(*args)


def _noisy_views(k, rs, hw, seed: int, noise_sigma: float, pool,
                 detail: bool = False):
    """(images, K float32, Rs float32): the views of cameras (k, rs) with
    Gaussian sensor noise drawn in view order from `seed`; `pool` (a
    multiprocessing pool) renders them in parallel."""
    rng = np.random.default_rng(seed)
    views = (pool.map if pool is not None else map)(
        _render_args, [(k, r, hw, seed, detail) for r in rs])
    images = [np.clip(view + rng.normal(0.0, noise_sigma, view.shape).astype(
        np.float32), 0.0, 255.0) for view in views]
    return images, k.astype(np.float32), np.stack(
        [r.astype(np.float32) for r in rs])


def make_ring_captures(n_images: int = 4, hw: Tuple[int, int] = (240, 320),
                       fov_deg: float = 55.0, pitch_deg: float = 0.0,
                       overlap_ratio: float = 0.45, seed: int = 7,
                       texture_detail: bool = False, pool=None):
    """A single-ring horizontal panorama: (images, K, Rs), with sigma-4
    per-view sensor noise; `texture_detail` renders the detailed texture
    (`sphere_texture_rgb`'s `detail`)."""
    k, rs = ring_geometry(n_images, hw, fov_deg, overlap_ratio, pitch_deg)
    return _noisy_views(k, rs, hw, seed, 4.0, pool, texture_detail)


def make_rig_captures(hw: Tuple[int, int] = (240, 320),
                      fov_deg: float = 68.0, rig: CaptureRig = DEFAULT_RIG,
                      seed: int = 7, noise_sigma: float = 4.0,
                      n_images: Optional[int] = None, pool=None):
    """The C++ reference's 5-ring capture rig: 37 images at the rig's own
    `rotation_prior` (pitch, yaw, roll), YXZ order, with Gaussian sensor
    noise: (images, K, Rs)."""
    n = rig.total_images if n_images is None else n_images
    rs = [np.asarray(euler_to_rotation_matrix(
        np.array(rig.rotation_prior(i), np.float32), "YXZ"), np.float64)
        for i in range(n)]
    return _noisy_views(_intrinsics(hw, fov_deg), rs, hw, seed,
                        noise_sigma, pool)


# The JAX package's BENCH_MODE=e2e ring (`bench.py:102-137`): 8 MP views.
E2E_RING = dict(n_images=8, hw=(2448, 3264), fov_deg=55.0, overlap_ratio=0.5,
                seed=7)
# The same ring with sigma-8 sensor noise, for the default configuration.
# At sigma 4 its 4000 full-resolution ORB features match some adjacent
# pairs with inlier ratios above 0.9, so n_inliers / (8 + 0.3 n_matches)
# exceeds 3 and the reference's near-duplicate rule (cv
# BestOf2NearestMatcher; `ops/matching.py::match_pairs`) zeroes those
# pairs; `tools/ring_features.py` prints the confidences per noise level.
DEFAULT_RING = dict(E2E_RING, noise_sigma=8.0)


def ring_view_noise(view: np.ndarray, i: int, sigma: float) -> np.ndarray:
    """View i of a `write_ring_dir` ring with its Gaussian sensor noise,
    drawn from its own seed 1000 + i, clipped to 0..255 float32."""
    noise = np.random.default_rng(1000 + i).normal(0.0, sigma, view.shape)
    return np.clip(view + noise.astype(np.float32), 0.0, 255.0)


def _render_noisy(args) -> np.ndarray:
    """One ring view with its sensor noise (worker process)."""
    i, k, r, hw, seed, sigma = args
    return ring_view_noise(render_view(k, r, hw, seed), i, sigma)


def write_ring_dir(directory: str, n_images: int, hw: Tuple[int, int],
                   fov_deg: float, overlap_ratio: float, seed: int = 7,
                   noise_sigma: float = 4.0,
                   plain_directory: Optional[str] = None):
    """Render a horizontal ring in a process pool (one view per worker,
    each with its own noise seed) and write it with EXIF pose payloads,
    and the same pixels without them to `plain_directory` when given.
    Returns the ground truth (K float64, [R float64]) as written."""
    import multiprocessing as mp
    k, rs = ring_geometry(n_images, hw, fov_deg, overlap_ratio)
    workers = max(1, min(n_images, os.cpu_count() or 1))
    with mp.get_context("spawn").Pool(workers) as pool:
        images = pool.map(_render_noisy,
                          [(i, k, r, hw, seed, noise_sigma)
                           for i, r in enumerate(rs)])
    rs32 = np.stack([r.astype(np.float32) for r in rs])
    write_capture_dir(directory, images, k.astype(np.float32), rs32)
    if plain_directory is not None:
        write_capture_dir(plain_directory, images, k.astype(np.float32),
                          rs32, with_exif=False)
    return k.astype(np.float64), [r.astype(np.float64) for r in rs32]


def write_capture_dir(directory: str, images: Sequence[np.ndarray], k,
                      rs, with_exif: bool = True) -> List[str]:
    """Numbered JPEGs, with EXIF pose payloads unless with_exif=False;
    frames are stored rotated 180 degrees, which `orient_capture` undoes
    on load."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, img in enumerate(images):
        path = os.path.join(directory, f"{i}.jpg")
        stored = image_io.rotate_180(np.clip(img, 0, 255).astype(np.uint8))
        if with_exif:
            payload = exif_mod.camera_to_image_description(
                focal=float(k[1, 1]), ppx=float(k[0, 2]),
                ppy=float(k[1, 2]), R=rs[i], is_portrait=False)
            image_io.write_jpeg_with_description(path, stored, payload,
                                                 quality=92)
        else:
            image_io.imwrite(path, stored, quality=92)
        paths.append(path)
    return paths
