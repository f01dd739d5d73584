"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled at first use, one `nvcc -c` per source, all
started together, then linked into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu
         -o build/<name>_<hash>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/libstitch_kernels_<hash>.so build/*_<hash>.o

in `image_stitching_tpu_torch/build/`, keyed by a hash of the sources and
flags, and loaded with ctypes.  Every entry point has a plain C interface:
device pointers and the CUDA stream are `void*`, and each returns the
`cudaGetLastError()` code of its launch.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["load_library", "check_launch", "build_seconds", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_state = {"lib": None, "seconds": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pvp, pci = ctypes.POINTER(vp), ctypes.POINTER(ci)
    lib.orb_sample_levels_launch.argtypes = [ci, pvp, pvp, pci, pci, vp, vp,
                                             vp, ci, ci, vp, vp, vp, vp, vp]
    lib.orb_sample_levels_launch.restype = ci
    lib.warp_bilinear_launch.argtypes = [vp, ci, ci, vp, vp, ci, ci, vp, vp]
    lib.warp_bilinear_launch.restype = ci
    lib.hamming_unpack_launch.argtypes = [vp, ctypes.c_longlong, ci, vp, vp]
    lib.hamming_unpack_launch.restype = ci
    lib.hamming_chunked_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                           ci, vp, vp, vp, vp, vp]
    lib.hamming_chunked_launch.restype = ci
    lib.hamming_chunked_max_k.argtypes = [ci, ci]
    lib.hamming_chunked_max_k.restype = ci
    lib.pyramid_accumulate_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp,
                                              vp, vp, vp]
    lib.pyramid_accumulate_launch.restype = ci
    lib.orb_detect_maps_launch.argtypes = [vp, ci, ci, ci, ci, ci, ci,
                                           ctypes.POINTER(ctypes.c_float),
                                           ci, ci, vp, vp, vp, vp, vp]
    lib.orb_detect_maps_launch.restype = ci
    lib.ransac_score_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                        ctypes.c_float, vp, vp]
    lib.ransac_score_launch.restype = ci


def _compile(sources, path: str, tag: str) -> None:
    """One `nvcc -c` per source, all running at once, then one link."""
    nvcc = _nvcc()
    objs = [os.path.join(_BUILD, f"{os.path.basename(src)[:-3]}_{tag}.o")
            for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate() for proc in procs]
    for src, proc, (_, err) in zip(sources, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                               f"({proc.returncode}):\n{err[-4000:]}")
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)


def load_library():
    """Compile (once per source hash) and load the kernel library."""
    if _state["lib"] is not None:
        return _state["lib"]
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    path = os.path.join(_BUILD, f"libstitch_kernels_{tag}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        _compile(sources, path, f"{tag}.{os.getpid()}")
    lib = ctypes.CDLL(path)
    _declare(lib)
    _state["seconds"] = time.perf_counter() - t0
    _state["lib"] = lib
    return lib


def build_seconds():
    """Seconds the first `load_library` call took (None before it)."""
    return _state["seconds"]


# Entry points return this plus a CUresult when the driver refuses a TMA
# tensor map (`csrc/hamming_chunked.cu`).
TENSOR_MAP_ERROR = 100000


def check_launch(code: int, name: str) -> None:
    if code >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {code - TENSOR_MAP_ERROR}")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
