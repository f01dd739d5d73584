"""Auto-cropper: shrink a composed panorama to its valid interior rect
(port of `ops/crop.py`).

`crop()` / `checkInteriorExterior` of the C++ reference's cropper: the
filled mask of the largest outer contour of gray > 0, then the bounding
rect shrinks step by step (each step counts the exterior pixels along the
four borders and moves the worst border inward) until it is clean.  Host
numpy and scipy, as in the reference: it runs once on the downloaded
panorama and is a sequential contour walk.  The stitch calls it behind
`StitchConfig.crop_result`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

__all__ = ["crop", "crop_rect", "check_interior_exterior"]


def check_interior_exterior(mask: np.ndarray,
                            rect: Tuple[int, int, int, int]):
    """`checkInteriorExterior`: (finished, top, bottom, left, right), the
    move flags of the rect (x, y, w, h) on `mask`."""
    x, y, w, h = rect
    sub = mask[y:y + h, x:x + w]
    top_row = int(np.count_nonzero(sub[0] == 0))
    bottom_row = int(np.count_nonzero(sub[-1] == 0))
    left_col = int(np.count_nonzero(sub[:, 0] == 0))
    right_col = int(np.count_nonzero(sub[:, -1] == 0))
    finished = (top_row + bottom_row + left_col + right_col) == 0

    top = bottom = left = right = 0
    if top_row > bottom_row:
        if top_row > left_col and top_row > right_col:
            top = 1
    elif bottom_row > left_col and bottom_row > right_col:
        bottom = 1
    if left_col >= right_col:
        if left_col >= bottom_row and left_col >= top_row:
            left = 1
    elif right_col >= top_row and right_col >= bottom_row:
        right = 1
    return finished, top, bottom, left, right


def crop_rect(img: np.ndarray) -> Tuple[int, int, int, int]:
    """The crop rect (x, y, w, h) of `crop()`, without cutting."""
    img8 = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if img8.ndim == 3:
        gray = (0.299 * img8[..., 0] + 0.587 * img8[..., 1] +
                0.114 * img8[..., 2])
    else:
        gray = img8.astype(np.float32)
    mask = gray > 0

    # The largest connected component is the largest outer contour's
    # region.
    labels, n = ndimage.label(mask)
    if n == 0:
        return (0, 0, img8.shape[1], img8.shape[0])
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    comp = labels == (1 + int(np.argmax(sizes)))
    filled = ndimage.binary_fill_holes(comp)
    contour_mask = np.where(filled, np.uint8(255), np.uint8(0))

    # Contour points (boundary pixels), sorted by x and by y: the
    # reference walks sorted index lists of them.
    eroded = ndimage.binary_erosion(filled, border_value=0)
    by, bx = np.nonzero(filled & ~eroded)
    xs = np.sort(bx)
    ys = np.sort(by)
    min_x_id, max_x_id = 0, len(xs) - 1
    min_y_id, max_y_id = 0, len(ys) - 1

    rect = (0, 0, img8.shape[1], img8.shape[0])
    while min_x_id < max_x_id and min_y_id < max_y_id:
        x0, y0 = int(xs[min_x_id]), int(ys[min_y_id])
        x1, y1 = int(xs[max_x_id]), int(ys[max_y_id])
        rect = (x0, y0, max(x1 - x0, 1), max(y1 - y0, 1))
        finished, top, bottom, left, right = check_interior_exterior(
            contour_mask, rect)
        if finished:
            break
        if left:
            min_x_id += 1
        if right:
            max_x_id -= 1
        if top:
            min_y_id += 1
        if bottom:
            max_y_id -= 1
    return rect


def crop(img: np.ndarray) -> np.ndarray:
    """`crop(cv::Mat&)`: the image cut to its crop rect."""
    x, y, w, h = crop_rect(img)
    return np.asarray(img)[y:y + h, x:x + w]
