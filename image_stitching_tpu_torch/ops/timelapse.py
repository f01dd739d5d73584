"""Timelapser: the per-frame compositing output mode (port of
`ops/timelapse.py`).

cv::detail::Timelapser (AS_IS, the union of the compose ROIs) and
TimelapserCrop (CROP, their intersection): each warped frame is pasted
onto a fresh canvas of that rect, on the device, and saved as
``fixed_<name>``.
"""

from __future__ import annotations

import os

import torch

from ..config import TimelapserType
from .warps import result_roi, result_roi_intersection

__all__ = ["Timelapser", "fixed_name"]


class Timelapser:
    def __init__(self, corners, sizes,
                 kind: TimelapserType = TimelapserType.CROP, device="cuda"):
        if kind == TimelapserType.CROP:
            self.roi = result_roi_intersection(corners, sizes)
        else:
            self.roi = result_roi(corners, sizes)
        self.kind = kind
        self.device = torch.device(device)
        self._reset()

    def _reset(self):
        # An empty intersection (a full ring under CROP) gives a 1x1 canvas.
        _, _, w, h = self.roi
        self.canvas = torch.zeros((max(h, 1), max(w, 1), 3),
                                  dtype=torch.float32, device=self.device)

    def process(self, img: torch.Tensor, mask, corner) -> torch.Tensor:
        """Timelapser::process: the frame (h, w, 3) pasted at its corner,
        clipped to the canvas, on a fresh canvas; returns the canvas."""
        self._reset()
        x0, y0, cw, ch = self.roi
        h, w = img.shape[0], img.shape[1]
        sx = max(corner[0], x0)
        sy = max(corner[1], y0)
        ex = min(corner[0] + w, x0 + cw)
        ey = min(corner[1] + h, y0 + ch)
        if ex <= sx or ey <= sy:
            return self.canvas
        self.canvas[sy - y0:ey - y0, sx - x0:ex - x0] = img[
            sy - corner[1]:ey - corner[1],
            sx - corner[0]:ex - corner[0]].to(torch.float32)
        return self.canvas

    def get_dst(self) -> torch.Tensor:
        return self.canvas


def fixed_name(path: str) -> str:
    """``fixed_<basename>``, the frame's file name."""
    return "fixed_" + os.path.basename(path)
