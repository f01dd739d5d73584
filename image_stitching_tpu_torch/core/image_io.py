"""Host-side image IO: decode/encode, directory scan, orientation rotate.

Port of `image_stitching_tpu/core/image_io.py`.  Decode takes the native
libjpeg/libpng runtime first and PIL second, as the reference does; PIL
(also the encoder, as in the reference) is imported only when it is
needed, so a machine without it can still decode through the native
runtime.  Images are uint8 RGB (H, W, 3) numpy arrays:
the codec is host work, and the pipeline uploads the decoded pixels to its
device explicitly.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np

from . import native

__all__ = ["list_images", "imread", "imread_batch", "imwrite",
           "probe_oriented_size",
           "rotate_90_cw", "rotate_180", "orient_capture",
           "write_jpeg_with_description", "codec_name"]

_EXTS = {".jpg", ".jpeg", ".png"}


def codec_name() -> str:
    """Which host decoder `imread` uses: the native runtime or PIL."""
    if native.available():
        return "native libstitch_runtime (libjpeg/libpng)"
    try:
        import PIL
    except ImportError:
        return "none"
    return f"PIL {PIL.__version__}"


def list_images(directory: str) -> List[str]:
    """jpg/jpeg/png files sorted by numeric filename prefix (strtol)."""
    entries = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if os.path.isfile(path) and \
                os.path.splitext(name)[1].lower() in _EXTS:
            entries.append(path)

    def strtol_prefix(p: str) -> int:
        m = re.match(r"\s*[+-]?\d+", os.path.basename(p))
        return int(m.group()) if m else 0

    entries.sort(key=strtol_prefix)
    return entries


def imread(path: str) -> np.ndarray:
    """Decode to uint8 RGB (H, W, 3): native runtime, else PIL."""
    img = native.read_image(path)
    if img is not None:
        return img
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imread_batch(paths, nthreads: int = 4) -> List[np.ndarray]:
    """Decode several files: the native runtime's threaded batch decode,
    else `imread` one by one."""
    out = native.read_images(list(paths), nthreads)
    if out is not None:
        return out
    return [imread(p) for p in paths]


def probe_oriented_size(path: str, is_portrait: bool) -> Tuple[int, int]:
    """(w, h) after `orient_capture`, from the codec header only."""
    wh = native.probe_image(path)
    if wh is None:
        from PIL import Image
        with Image.open(path) as im:
            wh = im.size
    w, h = wh
    return (h, w) if is_portrait else (w, h)


def _to_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return img


def imwrite(path: str, img, quality: int = 95) -> None:
    from PIL import Image
    Image.fromarray(_to_u8(img)).save(path, quality=quality)


def rotate_90_cw(img: np.ndarray) -> np.ndarray:
    """cv::ROTATE_90_CLOCKWISE."""
    return np.ascontiguousarray(np.rot90(img, k=-1, axes=(0, 1)))


def rotate_180(img: np.ndarray) -> np.ndarray:
    """cv::ROTATE_180."""
    return np.ascontiguousarray(img[::-1, ::-1])


def orient_capture(img: np.ndarray, is_portrait: bool) -> np.ndarray:
    """Portrait captures rotate 90 deg CW, landscape rotate 180."""
    return rotate_90_cw(img) if is_portrait else rotate_180(img)


def write_jpeg_with_description(path: str, img, description: str,
                                quality: int = 95) -> None:
    """Write a JPEG carrying an EXIF ImageDescription payload (PIL)."""
    from PIL import Image
    from .exif import IMAGE_DESCRIPTION_TAG
    pil = Image.fromarray(_to_u8(img))
    exif = Image.Exif()
    exif[IMAGE_DESCRIPTION_TAG] = description
    pil.save(path, quality=quality, exif=exif)
