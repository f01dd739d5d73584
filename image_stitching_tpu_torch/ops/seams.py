"""Seam finding, as far as the port's slice needs it (port of
`ops/seams.py:329,571`): the "no" finder, which keeps the warp masks, and
the half-octave bucket sizes the compose rects use."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["bucket_dim", "find_seams"]


def bucket_dim(x: int, lo: int = 16) -> int:
    """Next size >= x from the half-octave series {2^k, 1.5 * 2^k}."""
    b = lo
    while b < x:
        if b + (b >> 1) >= x:
            return b + (b >> 1)
        b <<= 1
    return b


def find_seams(masks: Sequence[np.ndarray],
               seam_type: str = "no") -> List[np.ndarray]:
    """seam_finder->find: with "no", the masks unchanged (as u8 copies).
    Other finders are not in the port yet."""
    if seam_type != "no":
        raise NotImplementedError(
            f"seam_find_type={seam_type!r}: the PyTorch port implements "
            "only 'no'")
    return [np.asarray(m).copy().astype(np.uint8) for m in masks]
