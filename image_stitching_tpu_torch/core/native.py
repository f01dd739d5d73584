"""ctypes binding to the shared C++ host runtime
(`native/libstitch_runtime.so`).

Port of `image_stitching_tpu/core/native.py`, reduced to what the slice
calls: header probe, JPEG/PNG decode, the EXIF
ImageDescription walk and union-find components.  The library is the one
the JAX package uses, loaded as it is.  Unlike the reference the library is
loaded (and, when absent, built with `make -C native`) on first use rather
than at import, so importing this module starts no process.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np

__all__ = ["available", "probe_image", "read_image", "exif_description",
           "biggest_component"]

_SRC_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                        "native"))
_LIB_PATH = os.path.join(_SRC_DIR, "libstitch_runtime.so")

_state = {"lib": None, "tried": False}


def _autobuild() -> None:
    """`make -C native` once; a failure leaves the pure-Python paths."""
    if os.environ.get("STITCH_NO_AUTOBUILD") or not os.path.exists(
            os.path.join(_SRC_DIR, "Makefile")):
        return
    try:
        subprocess.run(["make", "-C", _SRC_DIR], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        detail = ""
        if isinstance(e, subprocess.CalledProcessError) and e.stderr:
            detail = ": " + e.stderr.decode(errors="replace").strip(
                ).splitlines()[-1][:200]
        print(f"image_stitching_tpu_torch: native runtime build failed "
              f"({type(e).__name__}{detail}); using the Python host codec.",
              file=sys.stderr)


def _declare(lib) -> None:
    c_int = ctypes.c_int
    u8_p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64_p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32_p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.sr_probe_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_int),
                                   ctypes.POINTER(c_int)]
    lib.sr_probe_image.restype = c_int
    lib.sr_read_image.argtypes = [ctypes.c_char_p, u8_p, c_int,
                                  ctypes.POINTER(c_int),
                                  ctypes.POINTER(c_int)]
    lib.sr_read_image.restype = c_int
    lib.sr_exif_description.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        c_int]
    lib.sr_exif_description.restype = c_int
    lib.sr_biggest_component.argtypes = [f64_p, c_int, ctypes.c_double,
                                         i32_p]
    lib.sr_biggest_component.restype = c_int


def _lib():
    if not _state["tried"]:
        _state["tried"] = True
        if not os.path.exists(_LIB_PATH):
            _autobuild()
        if os.path.exists(_LIB_PATH):
            try:
                lib = ctypes.CDLL(_LIB_PATH)
                _declare(lib)
                _state["lib"] = lib
            except OSError:
                _state["lib"] = None
    return _state["lib"]


def available() -> bool:
    return _lib() is not None


def probe_image(path: str) -> Optional[tuple]:
    """Header-only (w, h) probe; None when unavailable."""
    lib = _lib()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.sr_probe_image(path.encode(), ctypes.byref(w),
                          ctypes.byref(h)) != 0:
        return None
    return (w.value, h.value)


def read_image(path: str) -> Optional[np.ndarray]:
    """Decode JPEG/PNG to uint8 RGB (H, W, 3); None if unavailable/failed."""
    lib = _lib()
    wh = probe_image(path)
    if lib is None or wh is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    out = np.empty((wh[1], wh[0], 3), np.uint8)
    rc = lib.sr_read_image(path.encode(), out, out.size, ctypes.byref(w),
                           ctypes.byref(h))
    return out if rc == 0 else None


def exif_description(path: str) -> Optional[str]:
    """ImageDescription payload; None when missing or lib unavailable."""
    lib = _lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(65536)
    if lib.sr_exif_description(path.encode(), buf, len(buf)) < 0:
        return None
    return buf.value.decode("utf-8", errors="replace")


def biggest_component(conf: np.ndarray,
                      thresh: float) -> Optional[List[int]]:
    lib = _lib()
    if lib is None:
        return None
    conf = np.ascontiguousarray(conf, np.float64)
    kept = np.zeros(conf.shape[0], np.int32)
    k = lib.sr_biggest_component(conf, conf.shape[0], thresh, kept)
    return [int(i) for i in kept[:k]]
