"""ctypes binding to the shared C++ host runtime (`native/stitch_runtime.cpp`).

Port of `image_stitching_tpu/core/native.py`, reduced to what the port
calls: header probes, JPEG/PNG decode (whole RGB; luma-only or DCT-scaled;
raw 4:2:0 planes), the background `DecodeSession`, the EXIF
ImageDescription walk, union-find components and the squared Euclidean
distance transform.

The library is found on first use, never at import, in this order:

1. `native/libstitch_runtime.so`, when it exists and loads (what
   `make -C native` builds where the codec headers are installed);
2. else the port's own build of the unchanged `native/stitch_runtime.cpp`:

       g++ -O3 -fPIC -std=c++17 -shared -I third_party/include
           [-DJPEG_LIB_VERSION=80] -o build/libstitch_runtime_<hash>.so
           native/stitch_runtime.cpp <libjpeg> <libpng16> -lpthread
           -Wl,-rpath,<their directories>

   in `image_stitching_tpu_torch/build/`, keyed by a hash of the source,
   the headers, the flags and the libraries.  The headers are vendored
   (`third_party/`), so the build needs no development package; the
   libraries are the machine's libjpeg and libpng16, the system copies if
   `ldconfig` lists them, else the copies bundled with Pillow
   (`<site-packages>/pillow.libs/`), linked by full path;
3. else `load()` raises RuntimeError with the build's error.

The fast-ingest path calls `load()` and so never falls back quietly;
`available()` reports whether it would succeed, for the legacy decode,
which takes PIL when the runtime is missing.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["load", "available", "runtime_info", "codec_libs",
           "build_runtime", "probe_image",
           "probe_jpeg_sampling", "yuv420_layout", "read_jpeg_yuv420",
           "read_image", "scaled_dims", "read_image_opts", "item_shape",
           "DecodeSession", "exif_description", "biggest_component",
           "edt_sq", "read_images", "write_jpeg", "dp_seam"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(os.path.dirname(_PKG), "native")
_SOURCE = os.path.join(_NATIVE, "stitch_runtime.cpp")
_TRACKED = os.path.join(_NATIVE, "libstitch_runtime.so")
_INCLUDE = os.path.join(_PKG, "third_party", "include")
_BUILD = os.path.join(_PKG, "build")

CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_state = {"lib": None, "error": None, "info": None}


def _declare(lib) -> None:
    c_int, c_i64 = ctypes.c_int, ctypes.c_int64
    p_int = ctypes.POINTER(c_int)
    u8_p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64_p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32_p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64_p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sr_probe_image.argtypes = [ctypes.c_char_p, p_int, p_int]
    lib.sr_probe_image.restype = c_int
    lib.sr_read_image.argtypes = [ctypes.c_char_p, u8_p, c_int, p_int, p_int]
    lib.sr_read_image.restype = c_int
    lib.sr_probe_jpeg_sampling.argtypes = [ctypes.c_char_p, p_int, p_int,
                                           p_int]
    lib.sr_probe_jpeg_sampling.restype = c_int
    lib.sr_read_jpeg_opts.argtypes = [ctypes.c_char_p, u8_p, c_i64, p_int,
                                      p_int, c_int, c_int]
    lib.sr_read_jpeg_opts.restype = c_int
    lib.sr_read_jpeg_raw.argtypes = [ctypes.c_char_p, u8_p, c_i64, p_int,
                                     p_int, c_int]
    lib.sr_read_jpeg_raw.restype = c_int
    lib.sr_decode_start.argtypes = [ctypes.c_char_p, c_int, i32_p, i32_p,
                                    i32_p, i32_p,
                                    ctypes.POINTER(ctypes.c_void_p), i64_p,
                                    i32_p, i32_p, i32_p, c_int]
    lib.sr_decode_start.restype = ctypes.c_void_p
    lib.sr_decode_wait.argtypes = [ctypes.c_void_p, c_int]
    lib.sr_decode_wait.restype = c_int
    lib.sr_decode_finish.argtypes = [ctypes.c_void_p]
    lib.sr_decode_finish.restype = None
    lib.sr_exif_description.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        c_int]
    lib.sr_exif_description.restype = c_int
    lib.sr_biggest_component.argtypes = [f64_p, c_int, ctypes.c_double,
                                         i32_p]
    lib.sr_biggest_component.restype = c_int
    lib.sr_edt_sq.argtypes = [u8_p, c_int, c_int,
                              np.ctypeslib.ndpointer(np.float32,
                                                     flags="C_CONTIGUOUS")]
    lib.sr_edt_sq.restype = None
    lib.sr_read_images.argtypes = [ctypes.c_char_p, c_int, u8_p, c_int,
                                   c_int, i32_p, i32_p, c_int]
    lib.sr_read_images.restype = c_int
    lib.sr_write_jpeg.argtypes = [ctypes.c_char_p, u8_p, c_int, c_int, c_int,
                                  ctypes.c_char_p]
    lib.sr_write_jpeg.restype = c_int
    lib.sr_dp_seam.argtypes = [np.ctypeslib.ndpointer(np.float32,
                                                      flags="C_CONTIGUOUS"),
                               c_int, c_int, i32_p]
    lib.sr_dp_seam.restype = None


def _ldconfig_libs() -> List[str]:
    """Paths of the shared libraries `ldconfig -p` lists (none when
    ldconfig is missing)."""
    exe = shutil.which("ldconfig") or next(
        (p for p in ("/sbin/ldconfig", "/usr/sbin/ldconfig")
         if os.path.exists(p)), None)
    if exe is None:
        return []
    try:
        out = subprocess.run([exe, "-p"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.split("=>")[-1].strip() for line in out.splitlines()
            if "=>" in line]


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def _pillow_libs() -> List[str]:
    """Shared libraries bundled with the Pillow wheel, found without
    importing PIL."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return []
    site = os.path.dirname(list(spec.submodule_search_locations)[0])
    return sorted(glob.glob(os.path.join(site, "[pP]illow.libs", "*.so*")))


def codec_libs() -> Tuple[str, str]:
    """(libjpeg, libpng16) shared objects to link the runtime against: the
    system copies when ldconfig lists loadable ones, else Pillow's."""
    system = _ldconfig_libs()
    found = []
    for stem, pattern in (("libjpeg", r"libjpeg\.so\.\d+"),
                          ("libpng16", r"libpng16\.so\.16")):
        cands = [p for p in system
                 if re.fullmatch(pattern, os.path.basename(p))]
        cands += [p for p in _pillow_libs()
                  if os.path.basename(p).startswith(stem + "-")]
        path = next((p for p in cands if _loads(p)), None)
        if path is None:
            raise RuntimeError(
                f"no loadable {stem} shared library: neither ldconfig nor "
                "Pillow's bundled libraries have one")
        found.append(path)
    return found[0], found[1]


def _jpeg_abi(path: str) -> int:
    """JPEG_LIB_VERSION of a libjpeg from its file name: .so.62 -> 62,
    .so.8 -> 80."""
    m = re.search(r"\.so\.(\d+)", os.path.basename(path))
    if m is None:
        raise RuntimeError(f"cannot read the libjpeg ABI of {path}")
    major = int(m.group(1))
    return major * 10 if major < 10 else major


def build_runtime() -> str:
    """Compile `native/stitch_runtime.cpp` against the vendored headers and
    the machine's libjpeg/libpng16 (once per hash); returns the .so path."""
    jpeg, png = codec_libs()
    abi = _jpeg_abi(jpeg)
    defines = [] if abi == 62 else [f"-DJPEG_LIB_VERSION={abi}"]
    rpath = ":".join(sorted({os.path.dirname(jpeg), os.path.dirname(png)}))
    digest = hashlib.sha256(" ".join(CXX_FLAGS + defines + [jpeg, png])
                            .encode())
    for path in [_SOURCE] + sorted(glob.glob(os.path.join(_INCLUDE, "*.h"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(_BUILD,
                       f"libstitch_runtime_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, *defines,
           "-I", _INCLUDE, "-o", tmp, _SOURCE, jpeg, png, "-lpthread",
           f"-Wl,-rpath,{rpath}"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native runtime build failed to start: {e}")
    if proc.returncode != 0:
        raise RuntimeError(f"native runtime build failed ({proc.returncode})"
                           f": {' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded runtime library; builds it on first use (see the module
    docstring).  Raises RuntimeError when neither the tracked library nor
    the port's build loads."""
    if _state["lib"] is not None:
        return _state["lib"]
    if _state["error"] is not None:
        raise RuntimeError(_state["error"])
    t0 = time.perf_counter()
    lib, origin, path = None, None, _TRACKED
    if os.path.exists(_TRACKED):
        try:
            lib, origin = ctypes.CDLL(_TRACKED), "tracked"
        except OSError:
            lib = None
    if lib is None:
        try:
            path = build_runtime()
            lib, origin = ctypes.CDLL(path), "built"
        except (RuntimeError, OSError) as e:
            _state["error"] = (f"native runtime unavailable: "
                               f"{_TRACKED} does not load and the build "
                               f"from {_SOURCE} failed: {e}")
            raise RuntimeError(_state["error"]) from e
    _declare(lib)
    _state["lib"] = lib
    _state["info"] = dict(origin=origin, path=path,
                          seconds=time.perf_counter() - t0)
    return lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def runtime_info() -> dict:
    """Which runtime loaded: origin ("tracked" or "built"), path, seconds
    the first load (and build) took, and the codec files it links, as
    `ldd` resolves them."""
    load()
    info = dict(_state["info"])
    out = subprocess.run(["ldd", info["path"]], capture_output=True,
                         text=True, timeout=30).stdout
    return dict(info, links=[
        line.split("=>")[1].split("(")[0].strip()
        for line in out.splitlines()
        if "=>" in line and re.search(r"lib(jpeg|png)", line)])


def probe_image(path: str) -> Optional[Tuple[int, int]]:
    """Header-only (w, h) probe; None when the runtime is missing or the
    header does not parse."""
    if not available():
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if load().sr_probe_image(path.encode(), ctypes.byref(w),
                             ctypes.byref(h)) != 0:
        return None
    return (w.value, h.value)


def probe_jpeg_sampling(path: str) -> Optional[Tuple[int, int, bool]]:
    """Header-only probe: (w, h, is_h2v2_ycc); None if not a JPEG.
    is_h2v2_ycc gates the raw-plane decode."""
    w, h, s = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if load().sr_probe_jpeg_sampling(path.encode(), ctypes.byref(w),
                                     ctypes.byref(h), ctypes.byref(s)) != 0:
        return None
    return (w.value, h.value, bool(s.value))


def yuv420_layout(w: int, h: int,
                  num8: int = 8) -> Tuple[int, int, int, int]:
    """iMCU-aligned plane strides of the raw 4:2:0 decode at scale num8/8:
    (ya_w, ya_h, ca_w, ca_h); the packed buffer is ya_w * ya_h +
    2 * ca_w * ca_h bytes.  w/h are the full (unscaled) dims."""
    ya_w = -(-w // 16) * 2 * num8
    ya_h = -(-h // 16) * 2 * num8
    return (ya_w, ya_h, ya_w // 2, ya_h // 2)


def scaled_dims(w: int, h: int, num8: int) -> Tuple[int, int]:
    """libjpeg's DCT-scaled output dims at num8/8: ceil(dim * num8 / 8)."""
    return (-(-w * num8 // 8), -(-h * num8 // 8))


def read_jpeg_yuv420(path: str,
                     num8: int = 8) -> Optional[Tuple[np.ndarray, int, int]]:
    """Raw-plane 4:2:0 decode at DCT scale num8/8: (packed u8 buffer, w,
    h) with w/h the scaled output dims; None for a file that is not h2v2
    YCbCr or fails to decode.  Plane layout per `yuv420_layout`."""
    lib = load()
    probe = probe_jpeg_sampling(path)
    if probe is None or not probe[2]:
        return None
    out = np.empty(item_shape(path, False, num8, True), np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.sr_read_jpeg_raw(path.encode(), out, out.size, ctypes.byref(w),
                            ctypes.byref(h), num8) != 0:
        return None
    return out, w.value, h.value


def read_image(path: str) -> Optional[np.ndarray]:
    """Decode JPEG/PNG to uint8 RGB (H, W, 3); None when the runtime is
    missing or the decode fails."""
    wh = probe_image(path)
    if wh is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    out = np.empty((wh[1], wh[0], 3), np.uint8)
    rc = load().sr_read_image(path.encode(), out, out.size, ctypes.byref(w),
                              ctypes.byref(h))
    return out if rc == 0 else None


def read_image_opts(path: str, gray: bool = False,
                    num8: int = 8) -> Optional[np.ndarray]:
    """JPEG decode, luma-only and/or DCT-scaled to num8/8: (H, W) u8 when
    gray else (H, W, 3); None on failure."""
    lib = load()
    shape = item_shape(path, gray, num8)
    out = np.empty(shape, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.sr_read_jpeg_opts(path.encode(), out, out.size, ctypes.byref(w),
                               ctypes.byref(h), 1 if gray else 0, num8)
    if rc != 0 or (h.value, w.value) != shape[:2]:
        return None
    return out


def item_shape(path: str, gray: bool = False, num8: int = 8,
               raw: bool = False) -> Tuple[int, ...]:
    """Shape of one decode's u8 output, from the header: (L,) packed 4:2:0
    planes when raw, else (H, W) gray or (H, W, 3) RGB at num8/8."""
    wh = probe_image(path)
    if wh is None:
        raise OSError(f"cannot probe {path}")
    if raw:
        ya_w, ya_h, ca_w, ca_h = yuv420_layout(wh[0], wh[1], num8)
        return (ya_w * ya_h + 2 * ca_w * ca_h,)
    ow, oh = scaled_dims(wh[0], wh[1], num8)
    return (oh, ow) if gray else (oh, ow, 3)


def _host_pointer(buf, shape) -> Tuple[int, int]:
    """(address, capacity in bytes) of a C-contiguous u8 host buffer that
    holds `shape`: a numpy array or a CPU torch tensor (pinned or not)."""
    need = int(np.prod(shape))
    if isinstance(buf, np.ndarray):
        ok = buf.dtype == np.uint8 and buf.flags.c_contiguous
        return (buf.ctypes.data, buf.nbytes) if ok and buf.size >= need \
            else (0, 0)
    ok = (str(buf.dtype) == "torch.uint8" and buf.device.type == "cpu"
          and buf.is_contiguous() and buf.numel() >= need)
    return (buf.data_ptr(), buf.numel()) if ok else (0, 0)


class DecodeSession:
    """Background-thread decode of (path, gray, num8[, raw]) items into
    host buffers; `wait(i)` blocks (the GIL released inside ctypes) until
    item i is decoded and returns its buffer.

    `buffers`, when given, are the caller's: one C-contiguous u8 numpy
    array or CPU torch tensor per item, at least `item_shape(*item)` in
    size (the stitcher hands pinned tensors on CUDA, so each upload can
    start as soon as its wait returns).  Otherwise numpy arrays are
    allocated.  The session holds the buffers until `finish`.  raw=True
    decodes packed 4:2:0 Y/Cb/Cr planes (`yuv420_layout`); precondition:
    the file is h2v2 YCbCr (the caller probes)."""

    def __init__(self, items: Sequence[Tuple], nthreads: int = 2,
                 buffers: Optional[Sequence] = None):
        lib = load()
        n = len(items)
        self.shapes = [item_shape(item[0], bool(item[1]), int(item[2]),
                                  bool(item[3]) if len(item) > 3 else False)
                       for item in items]
        if buffers is None:
            buffers = [np.empty(s, np.uint8) for s in self.shapes]
        if len(buffers) != n:
            raise ValueError(f"{len(buffers)} buffers for {n} items")
        ptrs = (ctypes.c_void_p * n)()
        caps = np.zeros(n, np.int64)
        for i, (buf, shape) in enumerate(zip(buffers, self.shapes)):
            ptrs[i], caps[i] = _host_pointer(buf, shape)
            if not ptrs[i]:
                raise ValueError(f"buffer {i} is not a C-contiguous u8 host "
                                 f"buffer of at least {shape}")
        self._buffers = list(buffers)
        grays = np.asarray([1 if it[1] else 0 for it in items], np.int32)
        num8s = np.asarray([int(it[2]) for it in items], np.int32)
        raws = np.asarray([1 if len(it) > 3 and it[3] else 0
                           for it in items], np.int32)
        self._ws = np.zeros(n, np.int32)
        self._hs = np.zeros(n, np.int32)
        self._rcs = np.zeros(n, np.int32)
        self._lib = lib
        self._handle = lib.sr_decode_start(
            "\n".join(it[0] for it in items).encode(), n, grays, num8s,
            np.zeros(n, np.int32), raws, ptrs, caps, self._ws, self._hs,
            self._rcs, nthreads)
        self._finished = False

    def wait(self, i: int):
        rc = self._lib.sr_decode_wait(self._handle, i)
        if rc != 0:
            raise OSError(f"decode failed for item {i} (rc={rc})")
        return self._buffers[i]

    def finish(self) -> None:
        if not self._finished and self._handle:
            self._lib.sr_decode_finish(self._handle)
            self._finished = True

    def __del__(self):
        try:
            self.finish()
        except Exception:
            pass


def exif_description(path: str) -> Optional[str]:
    """ImageDescription payload; None when missing or the runtime is
    missing."""
    if not available():
        return None
    buf = ctypes.create_string_buffer(65536)
    if load().sr_exif_description(path.encode(), buf, len(buf)) < 0:
        return None
    return buf.value.decode("utf-8", errors="replace")


def biggest_component(conf: np.ndarray,
                      thresh: float) -> Optional[List[int]]:
    if not available():
        return None
    conf = np.ascontiguousarray(conf, np.float64)
    kept = np.zeros(conf.shape[0], np.int32)
    k = load().sr_biggest_component(conf, conf.shape[0], thresh, kept)
    return [int(i) for i in kept[:k]]


def edt_sq(mask: np.ndarray) -> np.ndarray:
    """Exact squared Euclidean distance of every pixel to the nearest zero
    pixel of `mask` (Felzenszwalb's O(HW) transform, `sr_edt_sq`), float32;
    a mask with no zero pixel gives about 1e12 everywhere.  Raises when the runtime neither loads
    nor builds."""
    lib = load()
    mask = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    out = np.empty(mask.shape, np.float32)
    lib.sr_edt_sq(mask, mask.shape[0], mask.shape[1], out)
    return out


def read_images(paths: Sequence[str],
                nthreads: int = 4) -> Optional[List[np.ndarray]]:
    """Decode several JPEG/PNG files on `nthreads` native threads into
    uint8 RGB arrays; None when the runtime is missing, a file cannot be
    probed or a decode fails.  `sr_read_images` writes image i densely at
    the start of slot i, so each is read back as (h, w, 3) from there; the
    reference cuts the slot as (max_h, max_w, 3) rows, which is right only
    when every file has the largest width."""
    if not available() or not paths:
        return None
    dims = [probe_image(p) for p in paths]
    if any(d is None for d in dims):
        return None
    max_w = max(d[0] for d in dims)
    max_h = max(d[1] for d in dims)
    n = len(paths)
    out = np.empty((n, max_h, max_w, 3), np.uint8)
    ws = np.zeros(n, np.int32)
    hs = np.zeros(n, np.int32)
    if load().sr_read_images("\n".join(paths).encode(), n, out, max_w,
                             max_h, ws, hs, nthreads) != 0:
        return None
    slots = out.reshape(n, -1)
    return [slots[i, :hs[i] * ws[i] * 3].reshape(hs[i], ws[i], 3).copy()
            for i in range(n)]


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               exif_description_text: Optional[str] = None) -> bool:
    """Encode uint8 RGB (H, W, 3) to a JPEG, with an ImageDescription
    payload when given; False when the runtime is missing or the write
    fails."""
    if not available():
        return False
    img = np.ascontiguousarray(img, np.uint8)
    return load().sr_write_jpeg(
        path.encode(), img, img.shape[1], img.shape[0], quality,
        exif_description_text.encode() if exif_description_text
        else None) == 0


def dp_seam(cost: np.ndarray) -> Optional[np.ndarray]:
    """The min-cost vertical seam's column in each row of an (H, W) cost,
    int32; None when the runtime is missing."""
    if not available():
        return None
    cost = np.ascontiguousarray(cost, np.float32)
    out = np.zeros(cost.shape[0], np.int32)
    load().sr_dp_seam(cost, cost.shape[0], cost.shape[1], out)
    return out
