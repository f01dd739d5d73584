"""K7: RANSAC's hypothesis scoring, for a block of pairs, in one launch.

It replaces no TPU kernel: the JAX package leaves the scoring of
`ransac_homography` to XLA's fusion.  The CUDA kernel is
`csrc/ransac_score.cu`; `ransac_score_counts_plain` is the chain of
PyTorch ops it replaces (the gather of the scoring points, `apply_h`, the
squared errors and their count), which materialises (P, n_hyp, m) tensors.
`apply_h` lives here, beside the plain version that uses it;
`ops/ransac.py` re-exports it.
"""

from __future__ import annotations

import torch

from ..core.logging import count
from ._build import check_launch, load_library

__all__ = ["apply_h", "ransac_score_counts", "ransac_score_counts_plain"]


def apply_h(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., N, 2) -> (..., N, 2) projective transform."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = torch.einsum("...ij,...nj->...ni", h, p)
    z = q[..., 2:]
    return q[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)


def ransac_score_counts_plain(h_all: torch.Tensor, src: torch.Tensor,
                              dst: torch.Tensor, score_idx: torch.Tensor,
                              thresh: float) -> torch.Tensor:
    """`ransac_score_counts` in PyTorch ops."""
    n_hyp = h_all.shape[1]
    src_s = torch.gather(src, 1, score_idx[..., None].expand(-1, -1, 2))
    dst_s = torch.gather(dst, 1, score_idx[..., None].expand(-1, -1, 2))
    proj = apply_h(h_all, src_s[:, None].expand(-1, n_hyp, -1, -1))
    err2 = torch.sum((proj - dst_s[:, None]) ** 2, dim=-1)
    return torch.sum(err2 < thresh * thresh, dim=-1)


def _check(h_all, src, dst, score_idx):
    dev = h_all.device
    for name, x, dtype, ndim in (("h_all", h_all, torch.float32, 4),
                                 ("src", src, torch.float32, 3),
                                 ("dst", dst, torch.float32, 3),
                                 ("score_idx", score_idx, torch.int64, 2)):
        if x.dtype != dtype:
            raise TypeError(f"ransac_score_counts: {name} must be {dtype}, "
                            f"got {x.dtype}")
        if x.ndim != ndim:
            raise ValueError(f"ransac_score_counts: {name} must have {ndim} "
                             f"dimensions, got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"ransac_score_counts: {name} on {x.device}, "
                             f"h_all on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"ransac_score_counts: {name} must be "
                             f"contiguous")
    p, n_hyp = h_all.shape[:2]
    if (tuple(h_all.shape[2:]) != (3, 3) or src.shape[0] != p
            or src.shape[2] != 2 or dst.shape != src.shape
            or score_idx.shape[0] != p):
        raise ValueError(f"ransac_score_counts: h_all {tuple(h_all.shape)}, "
                         f"src {tuple(src.shape)}, dst {tuple(dst.shape)}, "
                         f"score_idx {tuple(score_idx.shape)}: need (P, "
                         f"n_hyp, 3, 3), (P, M, 2) twice and (P, m)")


def ransac_score_counts(h_all: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, score_idx: torch.Tensor,
                        thresh: float) -> torch.Tensor:
    """Inliers of each RANSAC hypothesis among a pair's scoring points, in
    one launch for a block of pairs.  h_all (P, n_hyp, 3, 3) float32; src,
    dst (P, M, 2) float32 correspondences; score_idx (P, m) int64 slots in
    [0, M).  Returns (P, n_hyp) int64: the scoring points whose squared
    error under `apply_h` is below thresh^2.  On the card a count can
    differ from the plain version's by points whose squared error lies
    within rounding of thresh^2 (the kernel's product order); an index
    outside [0, M) counts as no inlier there."""
    _check(h_all, src, dst, score_idx)
    dev = h_all.device
    if dev.type == "cpu":
        return ransac_score_counts_plain(h_all, src, dst, score_idx, thresh)
    if dev.type != "cuda":
        raise ValueError(f"ransac_score_counts: no kernel for device {dev}")
    p, n_hyp = h_all.shape[:2]
    counts = torch.empty((p, n_hyp), dtype=torch.int64, device=dev)
    if counts.numel() == 0:
        return counts
    lib = load_library()
    code = lib.ransac_score_launch(
        h_all.data_ptr(), src.data_ptr(), dst.data_ptr(),
        score_idx.data_ptr(), p, n_hyp, src.shape[1], score_idx.shape[1],
        float(thresh * thresh), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "ransac_score_counts")
    ransac_score_counts.launches += 1
    count("ransac.k7_pairs", p)
    return counts


ransac_score_counts.launches = 0
