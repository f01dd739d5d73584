"""EXIF sensor-prior ingestion and authoring (port of `core/exif.py`).

The rig stores pose priors in the ImageDescription tag as
``isPortrait;compassAngle;projMatrix;viewMatrix;cameraTransformMatrix;K``.
Host work in numpy and scipy; nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

from . import native
from .persistence import parse_matrix_str

__all__ = ["SensorPrior", "parse_image_description", "sensor_prior_to_camera",
           "read_image_description", "camera_to_image_description",
           "format_image_description"]

IMAGE_DESCRIPTION_TAG = 270


@dataclasses.dataclass
class SensorPrior:
    is_portrait: bool
    compass_angle: float
    proj: np.ndarray
    view: np.ndarray
    cam_transform: np.ndarray
    k: np.ndarray


def parse_image_description(payload: str) -> SensorPrior:
    parts = payload.split(";")
    if len(parts) < 6:
        raise ValueError(
            f"ImageDescription payload has {len(parts)} fields, expected 6")
    return SensorPrior(
        bool(int(parts[0].strip() or 0)),
        float(parts[1]) if parts[1].strip() else 0.0,
        parse_matrix_str(parts[2]), parse_matrix_str(parts[3]),
        parse_matrix_str(parts[4]), parse_matrix_str(parts[5]))


def sensor_prior_to_camera(prior: SensorPrior):
    """Prior -> (focal, aspect, ppx, ppy, R, t) with the rig's axis remap:
    portrait quaternion (y, x, -z, w), landscape (-x, y, -z, w)."""
    from scipy.spatial.transform import Rotation
    k = prior.k
    focal = float(k[1, 1])
    if prior.is_portrait:
        ppx, ppy = float(k[1, 2]), float(k[0, 2])
    else:
        ppx, ppy = float(k[0, 2]), float(k[1, 2])
    r = prior.cam_transform[:3, :3].astype(np.float64)
    t = prior.cam_transform[:3, 3].astype(np.float64)
    x, y, z, w = Rotation.from_matrix(r).as_quat()
    q2 = [y, x, -z, w] if prior.is_portrait else [-x, y, -z, w]
    r2 = Rotation.from_quat(q2).as_matrix()
    return focal, 1.0, ppx, ppy, r2.astype(np.float32), t.astype(np.float32)


def _parse_tiff_image_description(tiff: bytes) -> Optional[str]:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return None
    fmt = "<" if tiff[:2] == b"II" else ">"

    def u16(o):
        return struct.unpack_from(fmt + "H", tiff, o)[0]

    def u32(o):
        return struct.unpack_from(fmt + "I", tiff, o)[0]
    ifd = u32(4)
    if ifd + 2 > len(tiff):
        return None
    for i in range(u16(ifd)):
        entry = ifd + 2 + 12 * i
        if entry + 12 > len(tiff):
            break
        if u16(entry) != IMAGE_DESCRIPTION_TAG:
            continue
        n = u32(entry + 4)
        if n <= 4:
            raw = tiff[entry + 8: entry + 8 + n]
        else:
            off = u32(entry + 8)
            raw = tiff[off: off + n]
        return raw.rstrip(b"\x00").decode("utf-8", errors="replace")
    return None


def read_image_description(path: str) -> Optional[str]:
    """ImageDescription of a JPEG (APP1 Exif) or PNG (eXIf): the native
    runtime when it is built, the pure-Python walk otherwise."""
    if native.available():
        return native.exif_description(path)
    with open(path, "rb") as f:
        head = f.read(2)
        if head == b"\xff\xd8":
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF or marker[1] == 0xDA:
                    return None
                size = int.from_bytes(f.read(2), "big")
                body = f.read(size - 2)
                if marker[1] == 0xE1 and body.startswith(b"Exif\x00\x00"):
                    return _parse_tiff_image_description(body[6:])
        elif head == b"\x89P":
            f.seek(8)
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return None
                data = f.read(int.from_bytes(hdr[:4], "big"))
                f.read(4)
                if hdr[4:8] == b"eXIf":
                    return _parse_tiff_image_description(data)
                if hdr[4:8] == b"IEND":
                    return None
    return None


def _matrix_str(m) -> str:
    flat = np.asarray(m, dtype=np.float64).reshape(-1)
    return "[" + ",".join(repr(float(v)) for v in flat) + "]"


def format_image_description(is_portrait: bool, compass_angle: float,
                             proj, view, cam_transform, k) -> str:
    """A payload in the field order the reference parses."""
    return ";".join([str(int(bool(is_portrait))), repr(float(compass_angle)),
                     _matrix_str(proj), _matrix_str(view),
                     _matrix_str(cam_transform), _matrix_str(k)])


def camera_to_image_description(focal: float, ppx: float, ppy: float,
                                R, t=None, is_portrait: bool = False,
                                compass_angle: float = 0.0) -> str:
    """Payload that `sensor_prior_to_camera` parses back to
    (focal, ppx, ppy, R): the axis remap is an involution."""
    from scipy.spatial.transform import Rotation
    x, y, z, w = Rotation.from_matrix(np.asarray(R, np.float64)).as_quat()
    q_payload = [y, x, -z, w] if is_portrait else [-x, y, -z, w]
    cam_t = np.eye(4)
    cam_t[:3, :3] = Rotation.from_quat(q_payload).as_matrix()
    if t is not None:
        cam_t[:3, 3] = np.asarray(t, dtype=np.float64)
    k = np.array([[focal, 0.0, ppy if is_portrait else ppx],
                  [0.0, focal, ppx if is_portrait else ppy],
                  [0.0, 0.0, 1.0]])
    return format_image_description(is_portrait, compass_angle, np.eye(4),
                                    np.linalg.inv(cam_t), cam_t, k)
