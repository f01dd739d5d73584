"""Multiband blend helpers (port of `ops/blend.py:37,73`)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["WEIGHT_EPS", "num_bands_for"]

WEIGHT_EPS = 1e-5


def num_bands_for(canvas_roi, blend_strength: float) -> Tuple[int, float]:
    """(num_bands, blend_width) of cv MultiBandBlender for a canvas ROI."""
    area = canvas_roi[2] * canvas_roi[3]
    blend_width = float(np.sqrt(area) * blend_strength / 100.0)
    if blend_width < 1.0:
        return 0, blend_width
    return max(int(np.ceil(np.log2(blend_width)) - 1.0), 0), blend_width
