"""The benchmark's captures: a textured sphere seen through known cameras.

A frozen copy, with departures listed below, of the generator in
`image_stitching_tpu_torch/data/synth.py` (`sphere_texture_rgb`,
`render_view`, `ring_geometry`, `make_rig_captures`, `write_capture_dir`)
and of what it reaches in `core/exif.py` (`camera_to_image_description`),
`core/rig.py` (the C++ reference's 5-ring rig table), `geometry/euler.py`
(the YXZ Euler rotation) and `core/persistence.py` (the `cams.data` and
`indices.data` text formats).  The benchmark keeps its own copy so that a
change to the program never changes the yardstick; nothing here imports
the program.

Departures from `data/synth.py`, all so that the captures are made on the
device from the seed and the plain reference can render the same scene:

- the texture is evaluated with torch on the run's device, not numpy on
  the host; its random draws are numpy's, in `sphere_texture_rgb`'s order;
- the trig base layer is normalised by its range over the whole sphere
  (a 2048 x 1024 longitude-latitude grid), not over each view's pixels:
  the per-view normalisation is an offset and a scale of each view, which
  no gain compensation can undo;
- instead each view has an exposure of its own, a pure gain as a camera's
  auto-exposure gives it: `exposure_range` (lo, hi) spaced evenly over
  the views, in an order drawn from the set's noise seed, so every seed
  has the same gains and the exposure layer has them to undo;
- each view's sensor noise comes from a `torch.Generator` on the device.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

IMAGE_DESCRIPTION_TAG = 270
JPEG_QUALITY = 92

# `captureModeDesc[]`, image_stitching.cpp:96-102: (pitch deg, images,
# per-step yaw error deg, roll deg, explicit yaw table deg, yaw offset deg).
RIG_RINGS = (
    (0.0, 11, 1.0, 0.0, (), 0.0),
    (34.0, 9, 1.2, 0.0, (0, 36, 75.8, 115.8, 155.8, 195.8, 235.8, 275.8,
                         315.8), 4.1),
    (72.0, 4, 0.0, 0.0, (0, 83, 180, 277), 0.0),
    (-36.0, 9, 0.6, 0.0, (0, 36.7, 78, 117, 161.5, 200, 243, 279, 320), 4.1),
    (-72.0, 4, 0.0, 0.0, (0, 83, 180, 277), 0.0),
)


def rig_prior(idx: int) -> Tuple[float, float, float]:
    """(pitch, yaw, roll) in radians of rig image `idx`
    (`CalcRotation::operator()`, image_stitching.cpp:368-404)."""
    start = 0
    for pitch, total, error, roll, angles, start_y in RIG_RINGS:
        if idx - start < total:
            g = idx - start
            if len(angles) > 1 and angles[1] != 0:
                yaw = g * error + angles[g]
            else:
                yaw = g * (360.0 / total + error)
            yaw += start_y
            if yaw > 180.0:
                yaw -= 360.0
            return (math.radians(pitch), math.radians(yaw),
                    math.radians(roll))
        start += total
    raise IndexError(f"image {idx} beyond the rig")


def euler_yxz(x: float, y: float, z: float) -> np.ndarray:
    """Ry(y) Rx(x) Rz(z) from float32 angles, as float64."""
    x, y, z = (np.float32(a) for a in (x, y, z))
    cx, sx, cy, sy, cz, sz = (np.cos(x), np.sin(x), np.cos(y), np.sin(y),
                              np.cos(z), np.sin(z))
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return (ry @ rx @ rz).astype(np.float64)


def intrinsics(hw: Tuple[int, int], fov_deg: float) -> np.ndarray:
    """K (float64) of a centred camera with horizontal field fov_deg."""
    h, w = hw
    focal = (w / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
    return np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]],
                    np.float64)


def capture_geometry(capture: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(K float64, Rs (N, 3, 3) float64 of float32 values) of a capture
    description: `kind` "ring" (n_images, fov_deg, overlap_ratio, yaw
    step fov * (1 - overlap)) or "rig" (the 37-image rig, fov_deg)."""
    hw = tuple(capture["hw"])
    if capture["kind"] == "ring":
        step = math.radians(capture["fov_deg"]) * (1.0 - capture[
            "overlap_ratio"])
        rs = [euler_yxz(0.0, i * step, 0.0)
              for i in range(capture["n_images"])]
    elif capture["kind"] == "rig":
        rs = [euler_yxz(*rig_prior(i))
              for i in range(sum(r[1] for r in RIG_RINGS))]
    else:
        raise ValueError(f"unknown capture kind {capture['kind']!r}")
    rs = np.stack(rs).astype(np.float32).astype(np.float64)
    return intrinsics(hw, capture["fov_deg"]), rs


def texture_params(seed: int) -> Dict[str, np.ndarray]:
    """The texture's random draws, in `sphere_texture_rgb`'s order."""
    rng = np.random.default_rng(seed)
    base = []
    for c in range(3):
        for _ in range(6):
            fl = rng.integers(1, 9)
            fm = rng.integers(1, 9)
            ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
            base.append((c, fl, fm, ph1, ph2, rng.uniform(0.3, 1.0)))
    boxes = []
    for _ in range(400):
        lo = rng.uniform(-np.pi, np.pi)
        la = rng.uniform(-1.35, 1.15)
        dlo = rng.uniform(0.02, 0.22)
        dla = rng.uniform(0.02, 0.16)
        color = rng.uniform(-0.9, 0.9, 3).astype(np.float32)
        boxes.append((lo, la, dlo, dla, *color))
    return {"base": np.asarray(base, np.float64),
            "boxes": np.asarray(boxes, np.float64)}


class Texture:
    """The sphere texture of one seed, evaluated with torch on `device` in
    `dtype`: (lon, lat) -> (..., 3) values 0..255."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.params = texture_params(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        lon = torch.linspace(-math.pi, math.pi, 2048, device=self.device,
                             dtype=torch.float64)
        lat = torch.linspace(-math.pi / 2, math.pi / 2, 1024,
                             device=self.device, dtype=torch.float64)
        acc = self._base(lon[None, :], lat[:, None], torch.float64)
        self.lo = acc.amin(dim=(0, 1)).tolist()
        self.span = [max(hi - lo, 1e-6) for hi, lo in
                     zip(acc.amax(dim=(0, 1)).tolist(), self.lo)]

    def astype(self, dtype) -> "Texture":
        """The same texture evaluated in another dtype."""
        out = Texture.__new__(Texture)
        out.__dict__.update(self.__dict__)
        out.dtype = dtype
        return out

    def _base(self, lon, lat, dtype):
        out = []
        base = self.params["base"]
        for c in range(3):
            acc = torch.zeros(torch.broadcast_shapes(lon.shape, lat.shape),
                              dtype=dtype, device=self.device)
            for _, fl, fm, ph1, ph2, amp in base[base[:, 0] == c]:
                acc = acc + amp * torch.sin(fl * lon + ph1) * \
                    torch.cos(fm * lat + ph2)
            out.append(acc)
        return torch.stack(out, dim=-1)

    def __call__(self, lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        lon, lat = lon.to(dt), lat.to(dt)
        out = self._base(lon, lat, dt)
        lo = torch.tensor(self.lo, dtype=dt, device=self.device)
        span = torch.tensor(self.span, dtype=dt, device=self.device)
        out = torch.clamp((out - lo) / span, 0.0, 1.0)
        two_pi = 2 * math.pi
        lat_lo, lat_hi = float(lat.min()), float(lat.max())
        for lo_b, la, dlo, dla, r, g, b in self.params["boxes"]:
            if lat_hi < la or lat_lo >= la + dla:
                continue
            dlon = torch.remainder(lon - lo_b + math.pi, two_pi) - math.pi
            box = (dlon >= 0) & (dlon < dlo) & (lat >= la) & (lat < la + dla)
            color = torch.tensor([r, g, b], dtype=dt, device=self.device)
            out = out + box[..., None].to(dt) * color
        for amp, scale in ((0.22, 60.0), (0.15, 220.0), (0.12, 800.0)):
            cu = torch.floor(lon * scale)
            cv = torch.floor(lat * scale)
            for c in range(3):
                s = torch.sin(cu * 127.1 + cv * 311.7 + (17.0 * c + 1.0)) * \
                    43758.547
                out[..., c] = out[..., c] + amp * (s - torch.floor(s) - 0.5)
        return torch.clamp(out, 0.0, 1.0) * 255.0


def lonlat(rays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Longitude atan2(x, z) and latitude asin(y / |ray|) of (..., 3)."""
    norm = torch.linalg.vector_norm(rays, dim=-1)
    lon = torch.atan2(rays[..., 0], rays[..., 2])
    lat = torch.asin(torch.clamp(rays[..., 1] / torch.clamp(norm, min=1e-12),
                                 -1.0, 1.0))
    return lon, lat


def render_view(tex: Texture, k: np.ndarray, r: np.ndarray,
                hw: Tuple[int, int], rows: int = 512) -> torch.Tensor:
    """The texture seen by camera (k, r) at size hw, ray = R K^-1 p at the
    pixel centres' integer coordinates: (h, w, 3) float32 on the device."""
    h, w = hw
    dev = tex.device
    rk = torch.as_tensor(np.asarray(r, np.float64) @ np.linalg.inv(k),
                         device=dev)
    xs = torch.arange(w, device=dev, dtype=torch.float64)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    for y0 in range(0, h, rows):
        ys = torch.arange(y0, min(h, y0 + rows), device=dev,
                          dtype=torch.float64)
        pts = torch.stack(torch.broadcast_tensors(
            xs[None, :], ys[:, None], torch.ones(1, 1, device=dev,
                                                 dtype=torch.float64)), -1)
        lon, lat = lonlat(pts @ rk.T)
        out[y0:y0 + len(ys)] = tex(lon.float(), lat.float()).float()
    return out


def camera_to_image_description(focal: float, ppx: float, ppy: float,
                                R) -> str:
    """The landscape EXIF pose payload
    ``isPortrait;compassAngle;projMatrix;viewMatrix;cameraTransformMatrix;K``
    that the reference parses back to (focal, ppx, ppy, R)."""
    from scipy.spatial.transform import Rotation
    x, y, z, w = Rotation.from_matrix(np.asarray(R, np.float64)).as_quat()
    cam_t = np.eye(4)
    cam_t[:3, :3] = Rotation.from_quat([-x, y, -z, w]).as_matrix()
    k = np.array([[focal, 0.0, ppx], [0.0, focal, ppy], [0.0, 0.0, 1.0]])

    def mat(m):
        return "[" + ",".join(repr(float(v)) for v in
                              np.asarray(m, np.float64).reshape(-1)) + "]"
    return ";".join(["0", repr(0.0), mat(np.eye(4)), mat(np.linalg.inv(cam_t)),
                     mat(cam_t), mat(k)])


def write_jpeg(path: str, img: np.ndarray, description: str) -> None:
    """A JPEG carrying an EXIF ImageDescription payload (PIL)."""
    from PIL import Image
    pil = Image.fromarray(img)
    exif = Image.Exif()
    exif[IMAGE_DESCRIPTION_TAG] = description
    pil.save(path, quality=JPEG_QUALITY, exif=exif)


def _fmt(v: float) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return f"{float(v):.6g}"


def _matrix(m) -> str:
    m = np.asarray(m)
    if m.ndim == 1:
        m = m[:, None]
    return "[" + "".join(",".join(_fmt(v) for v in row) + ";"
                         for row in m) + "]"


def write_checkpoint(directory: str, k: np.ndarray, rs: np.ndarray,
                     indices: Sequence[int]) -> None:
    """`cams.data` (``aspect@focal@ppx@ppy@t@R`` a line) and `indices.data`
    in the reference's text formats, for cameras K (full resolution, work
    scale 1) and rotations rs."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "cams.data"), "w") as fs:
        for i in indices:
            fs.write(f"{_fmt(1.0)}@{_fmt(k[1, 1])}@{_fmt(k[0, 2])}@"
                     f"{_fmt(k[1, 2])}@{_matrix(np.zeros(3))}@"
                     f"{_matrix(rs[i])}\n")
    with open(os.path.join(directory, "indices.data"), "w") as fs:
        for i in indices:
            fs.write(f"{int(i)}\n")


def set_seeds(seed: int, n_sets: int) -> List[Tuple[int, int]]:
    """(texture seed, noise seed) of each capture set of a run's seed."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0)])
    return [tuple(int(v) for v in child.generate_state(2, np.uint32))
            for child in ss.spawn(n_sets)]


class CaptureSet:
    """One capture set: its directory, scene and ground truth."""

    def __init__(self, directory: str, texture: Texture, k: np.ndarray,
                 rs: np.ndarray, hw: Tuple[int, int], gains: np.ndarray):
        self.directory = directory
        self.texture = texture
        self.k = k
        self.rs = rs
        self.hw = hw
        self.gains = gains

    @property
    def n_images(self) -> int:
        return len(self.rs)

    @property
    def megapixels(self) -> float:
        return self.n_images * self.hw[0] * self.hw[1] / 1e6


def exposure_gains(capture: Dict, n: int, noise_seed: int) -> np.ndarray:
    """Each view's exposure: `exposure_range` (lo, hi) spaced evenly over
    the n views, in an order drawn from noise_seed; ones without it."""
    if "exposure_range" not in capture:
        return np.ones(n)
    lo, hi = capture["exposure_range"]
    gains = np.linspace(lo, hi, n)
    return gains[np.random.default_rng(noise_seed).permutation(n)]


def make_capture_set(directory: str, capture: Dict, tex_seed: int,
                     noise_seed: int, device,
                     pool: ThreadPoolExecutor) -> Tuple[CaptureSet, list]:
    """Render a capture set on `device` and start writing its JPEGs on
    `pool`: each view is the texture seen by its camera times the view's
    exposure gain, plus Gaussian noise of `noise_sigma`, clipped and truncated to uint8, stored rotated 180
    degrees (which the reader undoes) with its EXIF pose payload.  Returns
    the set and the writers' futures."""
    os.makedirs(directory, exist_ok=True)
    hw = tuple(capture["hw"])
    k, rs = capture_geometry(capture)
    tex = Texture(tex_seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    gains = exposure_gains(capture, len(rs), noise_seed)
    futures = []
    for i in range(len(rs)):
        view = float(gains[i]) * render_view(tex, k, rs[i], hw)
        view = view + capture["noise_sigma"] * torch.randn(
            view.shape, generator=gen, device=device, dtype=torch.float32)
        stored = torch.clamp(view, 0.0, 255.0).to(torch.uint8).flip(0, 1)
        payload = camera_to_image_description(k[1, 1], k[0, 2], k[1, 2],
                                              rs[i])
        futures.append(pool.submit(write_jpeg,
                                   os.path.join(directory, f"{i}.jpg"),
                                   stored.cpu().numpy(), payload))
    return CaptureSet(directory, tex, k, rs, hw, gains), futures
