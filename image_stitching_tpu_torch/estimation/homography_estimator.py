"""Camera seeding from the match graph, for captures without sensor priors
(port of `image_stitching_tpu/estimation/homography_estimator.py`).

cv::detail::HomographyBasedEstimator: per-image focals from the pairwise
homographies (autocalib, the median over confident ordered pairs), then
rotations chained over a maximum spanning tree of the match graph, each
projected onto SO(3).  cv::detail::AffineBasedEstimator chains the
pairwise affine transforms over the same tree instead.

Host numpy in float64, as in the reference, over the downloaded
MatchGraph.  The estimators return numpy camera fields (focal, aspect,
ppx, ppy, R, t), which the stitcher turns into `Cameras` on its device in
one place, as it does the EXIF priors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.rotation import orthonormalize

__all__ = ["focals_from_homography", "pair_focals", "estimate_focal",
           "max_spanning_tree", "estimate_rotations_from_homographies",
           "affine_based_estimate", "homography_based_estimate"]


def focals_from_homography(h) -> Tuple[Optional[float], Optional[float]]:
    """(f0, f1) estimates from one H, None where underdetermined
    (cv::detail::focalsFromHomography)."""
    h = np.asarray(h, np.float64).reshape(-1)

    f1 = None
    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    v1 = -(h[0] * h[1] + h[3] * h[4]) / d1 if d1 != 0 else -1.0
    v2 = ((h[0] * h[0] + h[3] * h[3] - h[1] * h[1] - h[4] * h[4]) / d2
          if d2 != 0 else -1.0)
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f1 = float(np.sqrt(v1 if abs(d1) > abs(d2) else v2))
    elif v1 > 0:
        f1 = float(np.sqrt(v1))

    f0 = None
    d1 = h[0] * h[3] + h[1] * h[4]
    d2 = h[0] * h[0] + h[1] * h[1] - h[3] * h[3] - h[4] * h[4]
    v1 = -h[2] * h[5] / d1 if d1 != 0 else -1.0
    v2 = (h[5] * h[5] - h[2] * h[2]) / d2 if d2 != 0 else -1.0
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f0 = float(np.sqrt(v1 if abs(d1) > abs(d2) else v2))
    elif v1 > 0:
        f0 = float(np.sqrt(v1))
    return f0, f1


def pair_focals(h_matrices: np.ndarray, confidence: np.ndarray,
                image_sizes: List[Tuple[int, int]],
                conf_thresh: float = 0.0) -> List[float]:
    """sqrt(f0 f1) of each ordered pair (i, j), i-major, with confidence >
    conf_thresh and both estimates determined, each H taken in centred
    coordinates.  image_sizes are (h, w)."""
    n = confidence.shape[0]
    ests = []
    for i in range(n):
        for j in range(n):
            if i == j or confidence[i, j] <= conf_thresh:
                continue
            wi, hi = image_sizes[i][1], image_sizes[i][0]
            wj, hj = image_sizes[j][1], image_sizes[j][0]
            # H_c = T_j H T_i^-1, T shifting the principal point to 0.
            ti_inv = np.array([[1, 0, 0.5 * wi], [0, 1, 0.5 * hi],
                               [0, 0, 1]], np.float64)
            tj_fwd = np.array([[1, 0, -0.5 * wj], [0, 1, -0.5 * hj],
                               [0, 0, 1]], np.float64)
            h_c = tj_fwd @ np.asarray(h_matrices[i, j], np.float64) @ ti_inv
            f0, f1 = focals_from_homography(h_c)
            if f0 is not None and f1 is not None:
                ests.append(float(np.sqrt(f0 * f1)))
    return ests


def estimate_focal(h_matrices: np.ndarray, confidence: np.ndarray,
                   image_sizes: List[Tuple[int, int]],
                   conf_thresh: float = 0.0) -> np.ndarray:
    """The median of `pair_focals`; with fewer than n - 1 of them,
    (w + h) / 2 per image (cv::detail::estimateFocal)."""
    n = confidence.shape[0]
    ests = pair_focals(h_matrices, confidence, image_sizes, conf_thresh)
    if len(ests) >= max(n - 1, 1):
        return np.full(n, float(np.median(ests)), np.float64)
    return np.array([(hw[0] + hw[1]) * 0.5 for hw in image_sizes],
                    np.float64)


def max_spanning_tree(weight: np.ndarray) -> List[Tuple[int, int]]:
    """Prim's algorithm from node 0, maximising edge weight: tree edges
    (u, v) in the order added.  Candidates are scanned tree node by tree
    node in insertion order, then the remaining nodes in ascending order,
    and a tie keeps the first edge found (the reference's order)."""
    n = weight.shape[0]
    in_tree = [0]
    edges = []
    remaining = set(range(1, n))
    while remaining:
        best = None
        for u in in_tree:
            for v in sorted(remaining):
                w = weight[u, v]
                if best is None or w > best[0]:
                    best = (w, u, v)
        _, u, v = best
        edges.append((u, v))
        in_tree.append(v)
        remaining.remove(v)
    return edges


def estimate_rotations_from_homographies(
        h_matrices: np.ndarray, focals: np.ndarray,
        image_sizes: List[Tuple[int, int]],
        weight: np.ndarray) -> np.ndarray:
    """(N, 3, 3) float32 rotations chained over the maximum spanning tree
    from R_0 = I: with ray = R K^-1 p and H_ij mapping p_i to p_j,
    R_j = R_i (K_j^-1 H_ij K_i)^T, each projected onto SO(3)."""
    n = len(focals)
    ks = []
    for idx in range(n):
        hgt, wid = image_sizes[idx]
        ks.append(np.array([[focals[idx], 0, 0.5 * wid],
                            [0, focals[idx], 0.5 * hgt],
                            [0, 0, 1]], np.float64))
    rs = [None] * n
    rs[0] = np.eye(3)
    for (u, v) in max_spanning_tree(weight):
        h_uv = np.asarray(h_matrices[u, v], np.float64)
        rel = np.linalg.inv(ks[v]) @ h_uv @ ks[u]
        r_v = rs[u] @ rel.T
        rs[v] = orthonormalize(torch.from_numpy(
            r_v.astype(np.float32))).numpy()
    return np.stack([np.asarray(r, np.float32) for r in rs])


def _fields(focal, ppx, ppy, rs) -> Dict[str, np.ndarray]:
    n = len(focal)
    return dict(focal=np.asarray(focal, np.float32),
                aspect=np.ones(n, np.float32),
                ppx=np.asarray(ppx, np.float32),
                ppy=np.asarray(ppy, np.float32),
                R=np.asarray(rs, np.float32),
                t=np.zeros((n, 3), np.float32))


def affine_based_estimate(pair_matches, image_sizes,
                          conf_thresh: float = 0.0) -> Dict[str, np.ndarray]:
    """cv::detail::AffineBasedEstimator: R holds each image's 3x3 affine
    into image 0's frame, A_j = A_i H_ij^-1 over the maximum spanning tree
    (H_ij mapping i to j); focal 1, principal point 0."""
    conf = np.asarray(pair_matches.confidence)
    h = np.asarray(pair_matches.h)
    n = conf.shape[0]
    weight = np.asarray(pair_matches.num_inliers) * (conf > conf_thresh)
    rs = [None] * n
    rs[0] = np.eye(3, dtype=np.float64)
    for (u, v) in max_spanning_tree(weight):
        h_uv = np.asarray(h[u, v], np.float64)
        h_uv = h_uv / h_uv[2, 2]
        rs[v] = rs[u] @ np.linalg.inv(h_uv)
    return _fields(np.ones(n), np.zeros(n), np.zeros(n),
                   np.stack([np.asarray(r, np.float32) for r in rs]))


def homography_based_estimate(pair_matches, image_sizes,
                              conf_thresh: float = 0.0
                              ) -> Dict[str, np.ndarray]:
    """Focals, rotations and centred principal points from the match
    graph; image_sizes are (h, w) at work scale."""
    conf = np.asarray(pair_matches.confidence)
    h = np.asarray(pair_matches.h)
    focals = estimate_focal(h, conf, image_sizes, conf_thresh)
    weight = np.asarray(pair_matches.num_inliers) * (conf > conf_thresh)
    rs = estimate_rotations_from_homographies(h, focals, image_sizes, weight)
    return _fields(focals, [0.5 * s[1] for s in image_sizes],
                   [0.5 * s[0] for s in image_sizes], rs)
