"""Turn the JAX package's state, as numpy arrays, into the port's.

The reference's `Cameras`, `Features` and `PairMatches` are
read through their attributes and `np.asarray`, so this module needs no
jax; the tests use it to feed both packages identical intermediate state.
uint32 descriptor words keep their bit pattern as int32; float descriptors
(SIFT, SURF) stay float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .geometry.camera import Cameras
from .ops.features.types import Features

__all__ = ["cameras_from_numpy", "features_from_numpy",
           "pair_matches_from_numpy"]


def _t(a, device, dtype=None):
    arr = np.array(a, copy=True)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def cameras_from_numpy(cams, device="cuda") -> Cameras:
    """focal/aspect/ppx/ppy (N,), R (N, 3, 3), t (N, 3) -> Cameras."""
    return Cameras.from_numpy(cams.focal, cams.aspect, cams.ppx, cams.ppy,
                              cams.R, cams.t, device=device)


def features_from_numpy(f, device="cuda") -> Features:
    """xy/response/angle/octave/size/desc/valid -> Features."""
    return Features(
        xy=_t(f.xy, device, torch.float32),
        response=_t(f.response, device, torch.float32),
        angle=_t(f.angle, device, torch.float32),
        octave=_t(f.octave, device, torch.int32),
        size=_t(f.size, device, torch.float32),
        desc=_t(f.desc, device,
                torch.float32 if np.issubdtype(np.asarray(f.desc).dtype,
                                               np.floating) else torch.int32),
        valid=_t(f.valid, device, torch.bool))


_PAIR_FIELDS = ("a_idx", "b_idx", "valid", "inlier", "h", "num_inliers",
                "confidence")


def pair_matches_from_numpy(pm, device="cuda") -> Dict[str, torch.Tensor]:
    """A reference PairMatches as a dict of tensors."""
    return {name: _t(getattr(pm, name), device) for name in _PAIR_FIELDS}

