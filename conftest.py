"""Repository-wide test set-up, loaded before `tests/conftest.py`.

Builds the JAX package's gitignored `native/libstitch_runtime.so` once,
before any test module imports `image_stitching_tpu.core.native`.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def build_native_runtime() -> None:
    """Build the JAX package's gitignored `native/libstitch_runtime.so`
    once, before any test module imports `image_stitching_tpu.core.native`.

    That import runs `make` in `native/` when the library is missing, and
    `make` writes the library in place: under xdist every worker did so at
    once, and a worker could load another's half-written file and fall
    back to no runtime.  Here the first worker to take an exclusive lock
    on the Makefile builds a copy of the sources in a temporary directory
    beside it and moves the library into place whole; the others wait for
    the lock and find it loading.  A failed build leaves the package's own
    fallback as it was."""
    makefile = os.path.join(NATIVE, "Makefile")
    lib = os.path.join(NATIVE, "libstitch_runtime.so")
    if os.environ.get("STITCH_NO_AUTOBUILD") or not os.path.exists(makefile):
        return
    with open(makefile, "rb") as lock:    # closing it releases the lock
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _loads(lib):
            return
        work = tempfile.mkdtemp(prefix=".build-", dir=NATIVE)
        try:
            for name in ("Makefile", "stitch_runtime.cpp"):
                shutil.copy2(os.path.join(NATIVE, name), work)
            subprocess.run(["make", "-C", work], check=True,
                           capture_output=True, timeout=300)
            os.replace(os.path.join(work, "libstitch_runtime.so"), lib)
        except (OSError, subprocess.SubprocessError):
            pass
        finally:
            shutil.rmtree(work, ignore_errors=True)


build_native_runtime()
