"""Checkpoint serializer with the reference's text formats.

Port of `image_stitching_tpu/core/persistence.py`: `cams.data`
(``aspect@focal@ppx@ppy@t@R`` per line), `indices.data`, and the EXIF
square-matrix text.  Numbers use C++ ostream 6-significant-digit format.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np

__all__ = ["serialize_matrix", "parse_matrix_str",
           "serialize_camera_params", "serialize_indices"]


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


def serialize_indices(indices: Sequence[int], directory: str = ".") -> str:
    path = os.path.join(directory, "indices.data")
    with open(path, "w") as fs:
        for i in indices:
            fs.write(f"{int(i)}\n")
    return path

