"""Checkpoint writers and readers with the reference's text formats.

Port of `image_stitching_tpu/core/persistence.py`: `cams.data`
(``aspect@focal@ppx@ppy@t@R`` per line), `indices.data`, the matrix text
``[a,b;c,d;]`` and the EXIF square-matrix text.  Numbers are written in
C++ ostream 6-significant-digit format; the readers take any float text
(scientific notation, too), as files written by the C++ reference hold.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence

import numpy as np

from ..geometry.camera import Cameras

__all__ = ["serialize_matrix", "deserialize_matrix", "parse_matrix_str",
           "serialize_camera_params", "deserialize_camera_params",
           "serialize_indices", "deserialize_indices"]


def _fmt(v: float) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    if v != v or math.isinf(v):
        return str(v)
    return f"{float(v):.6g}"


def serialize_matrix(m) -> str:
    """``[a,b;c,d;]``."""
    m = np.asarray(m)
    if m.ndim == 1:
        m = m[:, None]
    rows = [",".join(_fmt(m[r, c]) for c in range(m.shape[1])) + ";"
            for r in range(m.shape[0])]
    return "[" + "".join(rows) + "]"


def deserialize_matrix(s: str) -> np.ndarray:
    """``[a,b;c,d;]`` -> float32 rows (the reference reads CV_32F whatever
    was written)."""
    body = s.strip()
    if body.startswith("["):
        body = body[1:]
    if body.endswith("]"):
        body = body[:-1]
    rows = [r for r in body.split(";") if r.strip() != ""]
    return np.asarray([[float(x) for x in row.split(",")] for row in rows],
                      dtype=np.float32)


def parse_matrix_str(s: str) -> np.ndarray:
    """``[a,b,...]`` comma-only square matrix, row-major, float64."""
    items = [float(x) for x in s.strip()[1:-1].split(",")]
    n = int(math.isqrt(len(items)))
    return np.asarray(items[:n * n], dtype=np.float64).reshape(n, n)


def serialize_camera_params(cams, directory: str = ".") -> str:
    """Write ``cams.data`` from a `geometry.camera.Cameras`."""
    c = cams.numpy()
    focal = np.asarray(c["focal"], np.float64)
    aspect = np.asarray(c["aspect"], np.float64)
    ppx = np.asarray(c["ppx"], np.float64)
    ppy = np.asarray(c["ppy"], np.float64)
    rs = np.asarray(c["R"], np.float32)
    ts = np.asarray(c["t"], np.float32)
    path = os.path.join(directory, "cams.data")
    with open(path, "w") as fs:
        for i in range(len(focal)):
            fs.write(f"{_fmt(aspect[i])}@{_fmt(focal[i])}@{_fmt(ppx[i])}@"
                     f"{_fmt(ppy[i])}@{serialize_matrix(ts[i][:, None])}@"
                     f"{serialize_matrix(rs[i])}\n")
    return path


def deserialize_camera_params(directory: str = ".",
                              device="cuda") -> Cameras:
    """Read ``cams.data`` into `Cameras` (float32) on `device`."""
    focal, aspect, ppx, ppy, rs, ts = [], [], [], [], [], []
    with open(os.path.join(directory, "cams.data")) as fs:
        for line in fs:
            line = line.strip()
            if not line:
                continue
            a, f, px, py, t_str, r_str = line.split("@")
            aspect.append(float(a))
            focal.append(float(f))
            ppx.append(float(px))
            ppy.append(float(py))
            ts.append(deserialize_matrix(t_str).reshape(-1)[:3])
            rs.append(deserialize_matrix(r_str).reshape(3, 3))
    n = len(focal)
    return Cameras.from_numpy(
        focal=focal, aspect=aspect, ppx=ppx, ppy=ppy,
        R=np.asarray(rs, np.float32).reshape(n, 3, 3),
        t=np.asarray(ts, np.float32).reshape(n, 3), device=device)


def serialize_indices(indices: Sequence[int], directory: str = ".") -> str:
    path = os.path.join(directory, "indices.data")
    with open(path, "w") as fs:
        for i in indices:
            fs.write(f"{int(i)}\n")
    return path


def deserialize_indices(directory: str = ".") -> List[int]:
    """Read ``indices.data``: one kept-image index per line."""
    with open(os.path.join(directory, "indices.data")) as fs:
        return [int(line) for line in fs if line.strip()]

