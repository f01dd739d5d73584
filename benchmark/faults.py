"""The timed path broken underneath, to show that the judgement sees it.

Each fault wraps the program's `stitch()` and returns a stitch that is
wrong in one way; the tests drive a whole run with it, and
`calibrate.py --faults` reads its numbers on the card at a cell's size:

- `shifted`: an answer altered where it is produced, the panorama moved
  6 pixels;
- `turned`: an answer altered where it is produced, one camera turned 1
  degree;
- `half`: half of the batch left out: the stitch keeps the first half of
  its views and reports their true indices;
- `stale`: a step that returns its state unchanged, the first answer
  again;
- `exposure`: the exposure layer skipped, every gain left at one;
- `seams`: the seam layer skipped, the seam masks left as the warped
  masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _under(stitch: Callable, patch: Callable) -> Callable:
    """`stitch` run inside the context manager `patch()`."""
    def run(*args, **kw):
        with patch():
            return stitch(*args, **kw)
    return run


def shifted(stitch: Callable) -> Callable:
    def run(*args, **kw):
        res = stitch(*args, **kw)
        return dataclasses.replace(res, panorama=torch.roll(res.panorama, 6,
                                                            1))
    return run


def turned(stitch: Callable) -> Callable:
    def run(*args, **kw):
        res = stitch(*args, **kw)
        c, s = np.cos(np.radians(1.0)), np.sin(np.radians(1.0))
        turn = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                            dtype=res.cameras.R.dtype,
                            device=res.cameras.R.device)
        r = res.cameras.R.clone()
        r[1] = turn @ r[1]
        return dataclasses.replace(res, cameras=dataclasses.replace(
            res.cameras, R=r))
    return run


def half(stitch: Callable) -> Callable:
    from image_stitching_tpu_torch.core import persistence
    from image_stitching_tpu_torch.pipeline import stitcher
    component = stitcher.biggest_component
    read_indices = persistence.deserialize_indices
    read_cameras = persistence.deserialize_camera_params

    def first_half(n: int) -> int:
        return max(2, n // 2)

    def biggest_component(*args, **kw):
        kept, removed = component(*args, **kw)
        k = first_half(len(kept))
        return list(kept[:k]), sorted(list(removed) + list(kept[k:]))

    def deserialize_indices(*args, **kw):
        indices = read_indices(*args, **kw)
        return indices[:first_half(len(indices))]

    def deserialize_camera_params(*args, **kw):
        cams = read_cameras(*args, **kw)
        return cams[list(range(first_half(len(cams))))]

    @contextlib.contextmanager
    def patch():
        with patched(stitcher, "biggest_component", biggest_component), \
                patched(persistence, "deserialize_indices",
                        deserialize_indices), \
                patched(persistence, "deserialize_camera_params",
                        deserialize_camera_params):
            yield
    return _under(stitch, patch)


class _Stale:
    def __init__(self, stitch: Callable):
        self.stitch = stitch
        self.first = None

    def __call__(self, *args, **kw):
        if self.first is None:
            self.first = self.stitch(*args, **kw)
        return self.first


def stale(stitch: Callable) -> Callable:
    return _Stale(stitch)


def exposure(stitch: Callable) -> Callable:
    """The gain solve (`ops.exposure._fit_gains`, under both feeds) returns
    ones; the feeds themselves, which the run records, stay in place."""
    from image_stitching_tpu_torch.ops import exposure as exposure_ops
    fit = exposure_ops._fit_gains

    def unit(*args, **kw):
        comp = fit(*args, **kw)
        return dataclasses.replace(comp, gains=np.ones_like(comp.gains))
    return _under(stitch, lambda: patched(exposure_ops, "_fit_gains", unit))


def seams(stitch: Callable) -> Callable:
    """The DP seam finder (the configurations' `dp_color`) returns the
    masks it was given; `find_seams` itself, which the run records, stays
    in place."""
    from image_stitching_tpu_torch.ops import seams as seam_ops

    def unchanged(corners, masks, *args, **kw):
        return masks
    return _under(stitch, lambda: patched(seam_ops, "_find_seams_dp",
                                          unchanged))


FAULTS: Dict[str, Callable[[Callable], Callable]] = {
    "shifted": shifted, "turned": turned, "half": half, "stale": stale,
    "exposure": exposure, "seams": seams}
