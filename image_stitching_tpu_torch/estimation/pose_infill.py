"""Nearest-neighbour pose infill for dropped cameras (port of
`image_stitching_tpu/estimation/pose_infill.py`).

Images that the component filter removed get a pose made from the nearest
kept neighbour, searched within their rig ring first: the neighbour's
refined rotation with the sensor-prior delta between the two cameras added
as YXZ euler angles in yaw and pitch, roll zeroed (the C++ reference's
disabled elastic-recovery recipe, `image_stitching.cpp:754-866`).

Host numpy over camera fields (focal, aspect, ppx, ppy, R, t); the
stitcher turns the result into `Cameras` on its device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from ..core.rig import DEFAULT_RIG, CaptureRig
from ..geometry.euler import (euler_to_rotation_matrix,
                              rotation_matrix_to_euler)

__all__ = ["find_nearest_kept", "infill_dropped_cameras"]


def find_nearest_kept(kept: set, idx: int, n: int,
                      rig: Optional[CaptureRig]) -> Optional[int]:
    """Search outward from idx, one step up then one down, within its
    ring first (when the rig covers idx), then over all n."""
    if rig is not None and idx < rig.total_images:
        lo, hi = rig.group_start_end(rig.group_of(idx))
        i = j = idx
        while True:
            if i < hi:
                i += 1
            if j > lo:
                j -= 1
            if i in kept:
                return i
            if j in kept:
                return j
            if i == hi and j == lo:
                break
    i = j = idx
    while True:
        if i < n - 1:
            i += 1
        if j > 0:
            j -= 1
        if i in kept:
            return i
        if j in kept:
            return j
        if i == n - 1 and j == 0:
            return None


def infill_dropped_cameras(priors: Mapping[str, np.ndarray],
                           refined: Mapping[str, np.ndarray],
                           kept_indices: Sequence[int],
                           rig: Optional[CaptureRig] = DEFAULT_RIG
                           ) -> Dict[str, np.ndarray]:
    """All N cameras: the refined ones where kept, made from the nearest
    kept neighbour elsewhere (the raw prior when there is none).

    priors: the N sensor-prior cameras at work scale; refined: the
    len(kept_indices) bundle-adjusted cameras, in kept order."""
    n = len(priors["focal"])
    kept = set(int(i) for i in kept_indices)
    pos_of = {int(k): a for a, k in enumerate(kept_indices)}
    out = {name: np.array(priors[name], copy=True)
           for name in ("focal", "aspect", "ppx", "ppy", "R", "t")}
    r_prior = np.asarray(priors["R"])
    r_ref = np.asarray(refined["R"])
    for i in range(n):
        if i in kept:
            a = pos_of[i]
            out["R"][i] = r_ref[a]
        else:
            nb = find_nearest_kept(kept, i, n, rig)
            if nb is None:
                continue
            a = pos_of[nb]
            cur_e = rotation_matrix_to_euler(out["R"][i], "YXZ")
            ref_e = rotation_matrix_to_euler(r_prior[nb], "YXZ")
            base_e = rotation_matrix_to_euler(r_ref[a], "YXZ").copy()
            base_e[1] += cur_e[1] - ref_e[1]
            base_e[0] += cur_e[0] - ref_e[0]
            base_e[2] = 0.0
            out["R"][i] = euler_to_rotation_matrix(
                base_e.astype(np.float32), "YXZ")
        for name in ("focal", "ppx", "ppy"):
            out[name][i] = np.asarray(refined[name])[a]
    out["R"] = out["R"].astype(np.float32)
    return out
