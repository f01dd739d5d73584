"""Capture-rig model: maps image index -> expected (pitch, yaw, roll) prior.

A copy of `image_stitching_tpu/core/rig.py`: the hardcoded 5-ring rig of
the C++ reference (`image_stitching.cpp:87-213`, `CalcRotation` at
`:357-405`), pitch rings {0, 34, 72, -36, -72} deg holding {11, 9, 4, 9, 4}
images (37 total), with per-ring explicit yaw tables or uniform spacing
plus per-step error, an additive startY offset, and wrap past 180 deg.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

__all__ = ["CaptureModeDesc", "CAPTURE_MODE", "CaptureRig", "DEFAULT_RIG"]


@dataclasses.dataclass(frozen=True)
class CaptureModeDesc:
    """One ring: `image_stitching.cpp:87-94`."""
    x: float = 0.0            # ring pitch, degrees
    total_img: int = 0        # images in ring
    error: float = 0.0        # per-step yaw error, degrees
    z_error: float = 0.0      # roll prior, degrees
    angles: Tuple[float, ...] = ()  # explicit yaw table (degrees) or empty
    start_y: float = 0.0      # additive yaw offset, degrees


# `captureModeDesc[]` at image_stitching.cpp:96-102.
CAPTURE_MODE: Tuple[CaptureModeDesc, ...] = (
    CaptureModeDesc(0.0, 11, 1.0, 0.0, (), 0.0),
    CaptureModeDesc(34.0, 9, 1.2, 0.0,
                    (0, 36, 75.8, 115.8, 155.8, 195.8, 235.8, 275.8, 315.8),
                    4.1),
    CaptureModeDesc(72.0, 4, 0.0, 0.0, (0, 83, 180, 277), 0.0),
    CaptureModeDesc(-36.0, 9, 0.6, 0.0,
                    (0, 36.7, 78, 117, 161.5, 200, 243, 279, 320), 4.1),
    CaptureModeDesc(-72.0, 4, 0.0, 0.0, (0, 83, 180, 277), 0.0),
)


@dataclasses.dataclass(frozen=True)
class CaptureRig:
    """Queryable rig; default instance == the reference's table."""
    rings: Tuple[CaptureModeDesc, ...] = CAPTURE_MODE

    @property
    def total_images(self) -> int:
        return sum(r.total_img for r in self.rings)

    def group_of(self, idx: int) -> int:
        """`getGroup` (image_stitching.cpp:104-115)."""
        cur = 0
        for g, ring in enumerate(self.rings):
            if idx - cur < ring.total_img:
                return g
            cur += ring.total_img
        raise IndexError(f"image index {idx} beyond rig ({self.total_images})")

    def group_index(self, idx: int, group: int) -> int:
        """`getGroupIdx` (image_stitching.cpp:117-124)."""
        return idx - sum(r.total_img for r in self.rings[:group])

    def group_start_end(self, group: int) -> Tuple[int, int]:
        """`getGroupStartEnd` (image_stitching.cpp:188-196), inclusive."""
        start = sum(r.total_img for r in self.rings[:group])
        return start, start + self.rings[group].total_img - 1

    def rotation_prior(self, idx: int) -> Tuple[float, float, float]:
        """Expected (pitch, yaw, roll) in radians for image `idx`.

        `CalcRotation::operator()` (image_stitching.cpp:368-404): explicit
        yaw table is used when angles[1] != 0 (plus per-step error), else
        uniform 360/N spacing plus error; startY added; wrapped past 180.
        """
        group = self.group_of(idx)
        desc = self.rings[group]
        gidx = self.group_index(idx, group)
        has_table = len(desc.angles) > 1 and desc.angles[1] != 0
        if has_table:
            yaw = gidx * desc.error + desc.angles[gidx]
        else:
            yaw = gidx * (360.0 / desc.total_img + desc.error)
        yaw += desc.start_y
        if yaw > 180.0:
            yaw -= 360.0
        return (math.radians(desc.x), math.radians(yaw),
                math.radians(desc.z_error))

    def field_rect(self, fov_w: float, fov_h: float, idx: int):
        """`getFieldRect` (image_stitching.cpp:198-213): angular rect of an
        image's nominal footprint (x=yaw slot, y=ring pitch, w/h=fov)."""
        group = self.group_of(idx)
        start, _ = self.group_start_end(group)
        desc = self.rings[group]
        return ((2.0 * math.pi) / desc.total_img * (idx - start), desc.x,
                fov_w, fov_h)


DEFAULT_RIG = CaptureRig()
