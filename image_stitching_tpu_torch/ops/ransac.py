"""RANSAC homography and similarity, batched over a leading pair axis
(port of `ops/ransac.py`).

Same estimators as the reference.  Homography: `n_hyp` closed-form 4-point
hypotheses (unit-square route, no linear solve), scoring on a subsample of
at most 1024 correspondences (kernel K7 for CUDA tensors,
`kernels/ransac_score.py`), the winner's full inlier mask, then four
Cauchy-weighted DLT refits (IRLS) kept only if they do not lose inliers.
Similarity (cv::estimateAffinePartial2D, the affine matcher's core):
`n_hyp` 2-point hypotheses scored on every correspondence, then one
least-squares refit of (a, b, tx, ty) on the winner's consensus, kept only
if it does not lose inliers.

Randomness is the reference's: each pair has a threefry key (`core/prng.py`,
`jax.random`'s draws bit for bit), the hypotheses take `uniform(key,
(n_hyp, k))` and the homography's scoring subsample `uniform(fold_in(key,
1), (min(M, 1024),))`, so a pair draws the same numbers as in the
reference, alone or in any batch, on any device.  Both estimators also
take their hypothesis indices (and the homography its scoring indices)
directly, for tests that hold one stage alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.logging import span
from ..core.prng import check_key, fold_in, uniform
from ..kernels.ransac_score import apply_h, ransac_score_counts

__all__ = ["apply_h", "h4_closed_form", "dlt_homography",
           "sample_valid", "sample_valid_distinct", "ransac_draws",
           "ransac_homography", "ransac_affine_partial"]


def _normalizer(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalisation (..., 3, 3) from weighted stats of
    (..., N, 2) points."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-6)
    mean = torch.sum(pts * w[..., None], dim=-2) / wsum[..., None]
    d = torch.sqrt(torch.sum((pts - mean[..., None, :]) ** 2, dim=-1))
    mean_d = torch.sum(d * w, dim=-1) / wsum
    s = 1.4142135623730951 / torch.clamp(mean_d, min=1e-6)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], -1),
        torch.stack([zero, s, -s * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    """inv(M) up to the 1/det factor (homographies are scale-free)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    r0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1)
    r1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1)
    r2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)
    return torch.stack([r0, r1, r2], -2)


def _quad_h(q: torch.Tensor) -> torch.Tensor:
    """Projective map unit square -> quad (Heckbert), (..., 4, 2) ->
    (..., 3, 3)."""
    x0, y0 = q[..., 0, 0], q[..., 0, 1]
    x1, y1 = q[..., 1, 0], q[..., 1, 1]
    x2, y2 = q[..., 2, 0], q[..., 2, 1]
    x3, y3 = q[..., 3, 0], q[..., 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    den = dx1 * dy2 - dy1 * dx2
    den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    g = (sx * dy2 - sy * dx2) / den
    h = (dx1 * sy - dy1 * sx) / den
    r0 = torch.stack([x1 - x0 + g * x1, x3 - x0 + h * x3, x0], -1)
    r1 = torch.stack([y1 - y0 + g * y1, y3 - y0 + h * y3, y0], -1)
    r2 = torch.stack([g, h, torch.ones_like(g)], -1)
    return torch.stack([r0, r1, r2], -2)


def h4_closed_form(s4: torch.Tensor, d4: torch.Tensor) -> torch.Tensor:
    """4-point homography (..., 4, 2) x (..., 4, 2) -> (..., 3, 3)."""
    h = _quad_h(d4) @ _adjugate3(_quad_h(s4))
    h22 = h[..., 2:3, 2:3]
    return h / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)


def _compact_order(valid: torch.Tensor) -> torch.Tensor:
    """Indices with the valid slots first, in slot order (stable)."""
    return torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)


def sample_valid(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Uniform picks among the valid slots of each row of (P, M) `valid`,
    from uniforms u (P, m)."""
    order = _compact_order(valid)
    n_valid = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1)
    pick = torch.minimum((u * n_valid).to(torch.int64), n_valid - 1)
    return torch.gather(order, -1, pick)


def sample_valid_distinct(u: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """(P, n_rows, k) indices into the valid slots, distinct within a row,
    from uniforms u (P, n_rows, k): slot j draws in [0, n_valid - j) and
    shifts past the earlier picks in ascending order."""
    order = _compact_order(valid)
    n_valid = torch.clamp(torch.sum(valid, dim=-1), min=1)[:, None]
    chosen = []
    for j in range(u.shape[-1]):
        rng_j = torch.clamp(n_valid - j, min=1)
        v = torch.minimum((u[..., j] * rng_j).to(torch.int64), rng_j - 1)
        if chosen:
            prev = torch.sort(torch.stack(chosen, -1), dim=-1).values
            for t in range(j):
                v = v + (v >= prev[..., t]).to(torch.int64)
        chosen.append(torch.minimum(v, n_valid - 1))
    idx = torch.stack(chosen, -1)
    p, r, k = idx.shape
    return torch.gather(order, -1, idx.reshape(p, r * k)).reshape(p, r, k)


def dlt_homography(src: torch.Tensor, dst: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Weighted normalised DLT over (P, N, 2) correspondences -> (P, 3, 3):
    smallest eigenvector of A^T diag(w) A."""
    tn_s = _normalizer(src, w)
    tn_d = _normalizer(dst, w)
    sn = apply_h(tn_s, src)
    dn = apply_h(tn_d, dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    row2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    a = torch.cat([row1, row2], dim=-2)                       # (P, 2N, 9)
    ww = torch.cat([w, w], dim=-1)
    ata = (a * ww[..., None]).transpose(-1, -2) @ a           # (P, 9, 9)
    _, evecs = torch.linalg.eigh(ata)
    hn = evecs[..., :, 0].reshape(-1, 3, 3)
    h = torch.linalg.inv(tn_d) @ hn @ tn_s
    h22 = h[..., 2:3, 2:3]
    return h / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)


def ransac_draws(key: torch.Tensor, n_hyp: int, k: int, m_score: int = 0):
    """The uniforms pair p draws from its key[p], key (P, 2), as the
    reference draws them: (P, n_hyp, k) under key[p] for its k-point
    hypotheses and, when m_score > 0, (P, m_score) under fold_in(key[p],
    1) for the homography's scoring subsample (else None).  Three
    threefry calls for the whole block of pairs."""
    check_key(key)
    return (uniform(key, (n_hyp, k)),
            uniform(fold_in(key, 1), (m_score,)) if m_score else None)


def _pair_draws(key, draws, p: int, n_hyp: int, k: int, m_score: int,
                device):
    """`draws` as given (checked against the pairs' shapes), else
    `ransac_draws` of the pairs' keys (P, 2) on the points' device."""
    if draws is None:
        if key is None:
            raise ValueError("RANSAC needs the pairs' keys (P, 2) unless "
                             "its draws are given")
        return ransac_draws(check_key(key, (p,)).to(device), n_hyp, k,
                            m_score)
    u_hyp, u_score = draws
    if tuple(u_hyp.shape) != (p, n_hyp, k) or (
            m_score and tuple(u_score.shape) != (p, m_score)):
        raise ValueError(f"draws of shapes {tuple(u_hyp.shape)} and "
                         f"{None if u_score is None else tuple(u_score.shape)}"
                         f" for {p} pairs, n_hyp {n_hyp}, {k} points, "
                         f"{m_score} scoring slots")
    return u_hyp, u_score


def ransac_homography(src: torch.Tensor, dst: torch.Tensor,
                      valid: torch.Tensor,
                      key: Optional[torch.Tensor] = None,
                      thresh: float = 3.0, n_hyp: int = 512,
                      hyp_idx: Optional[torch.Tensor] = None,
                      score_idx: Optional[torch.Tensor] = None,
                      draws=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC H per pair.  src, dst (P, M, 2); valid (P, M) bool; key
    (P, 2), pair p's threefry key.  Returns (H (P, 3, 3), inlier mask
    (P, M), n_inliers (P,)).

    Pair p draws its hypotheses from uniform(key[p], (n_hyp, 4)) and its
    scoring subsample from uniform(fold_in(key[p], 1), (min(M, 1024),)),
    as the reference does; `draws`, those uniforms as `ransac_draws` gives
    them, replace the key (`match_all_pairs` draws a block of pairs at
    once); hyp_idx (P, n_hyp, 4) and score_idx (P, min(M, 1024)) replace
    the draws when given."""
    p, m = valid.shape
    m_score = min(m, 1024)
    if hyp_idx is None or score_idx is None:
        u_hyp, u_score = _pair_draws(key, draws, p, n_hyp, 4, m_score,
                                     src.device)
    if hyp_idx is None:
        hyp_idx = sample_valid_distinct(u_hyp, valid)
    if score_idx is None:
        score_idx = sample_valid(u_score, valid)
    n_hyp = hyp_idx.shape[1]
    flat = hyp_idx.reshape(p, -1)
    s4 = torch.gather(src, 1, flat[..., None].expand(-1, -1, 2)).reshape(
        p, n_hyp, 4, 2)
    d4 = torch.gather(dst, 1, flat[..., None].expand(-1, -1, 2)).reshape(
        p, n_hyp, 4, 2)

    scale = torch.clamp(torch.amax(torch.where(valid[..., None],
                                               torch.abs(src), 0.0),
                                   dim=(1, 2)), min=1.0)       # (P,)
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    t = eye.repeat(p, 1, 1)
    tinv = eye.repeat(p, 1, 1)
    t[:, 0, 0] = 1.0 / scale
    t[:, 1, 1] = 1.0 / scale
    tinv[:, 0, 0] = scale
    tinv[:, 1, 1] = scale
    sc = scale[:, None, None, None]
    h_n = h4_closed_form(s4 / sc, d4 / sc)
    h_all = torch.einsum("pij,pnjk,pkl->pnil", tinv, h_n, t)

    with span("K7", pairs=p, n_hyp=n_hyp, m=score_idx.shape[1]):
        counts = ransac_score_counts(h_all.contiguous(), src.contiguous(),
                                     dst.contiguous(), score_idx.contiguous(),
                                     thresh)
    det = torch.abs(torch.linalg.det(h_all))
    counts = torch.where(det > 1e-8, counts, -1)
    best = torch.argmax(counts, dim=-1)
    h_best0 = h_all[torch.arange(p, device=src.device), best]

    def inliers(h):
        e2 = torch.sum((apply_h(h, src) - dst) ** 2, dim=-1)
        return (e2 < thresh * thresh) & valid, e2
    mask0, _ = inliers(h_best0)
    sig2 = (0.5 * thresh) ** 2
    h_fit = h_best0
    for _ in range(4):
        _, e2 = inliers(h_fit)
        w = torch.where(valid, 1.0 / (1.0 + e2 / sig2), 0.0)
        h_fit = dlt_homography(src, dst, w.to(src.dtype))
    mask, _ = inliers(h_fit)
    use_fit = torch.sum(mask, -1) >= torch.sum(mask0, -1)
    h_out = torch.where(use_fit[:, None, None], h_fit, h_best0)
    mask = torch.where(use_fit[:, None], mask, mask0)
    return h_out, mask, torch.sum(mask, dim=-1)


def _gather_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts (P, M, 2) at idx (P, R, k) -> (P, R, k, 2)."""
    p, r, k = idx.shape
    flat = idx.reshape(p, r * k)
    return torch.gather(pts, 1, flat[..., None].expand(-1, -1, 2)).reshape(
        p, r, k, 2)


def _similarity(a, b, tx, ty) -> torch.Tensor:
    """The (..., 3, 3) similarities [[a, -b, tx], [b, a, ty], [0, 0, 1]]."""
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def ransac_affine_partial(src: torch.Tensor, dst: torch.Tensor,
                          valid: torch.Tensor,
                          key: Optional[torch.Tensor] = None,
                          thresh: float = 3.0, n_hyp: int = 512,
                          hyp_idx: Optional[torch.Tensor] = None,
                          draws=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """RANSAC similarity (rotation, scale, translation) per pair.  src, dst
    (P, M, 2); valid (P, M) bool; key (P, 2).  Returns (H (P, 3, 3) with
    affine rows, inlier mask (P, M), n_inliers (P,)).

    Pair p draws from uniform(key[p], (n_hyp, 2)), as the reference does
    (or takes those uniforms from `draws`, as `ransac_draws` gives them);
    hyp_idx (P, n_hyp, 2), two distinct valid slots per hypothesis,
    replaces the draws when given."""
    p = valid.shape[0]
    if hyp_idx is None:
        u_hyp, _ = _pair_draws(key, draws, p, n_hyp, 2, 0, src.device)
        hyp_idx = sample_valid_distinct(u_hyp, valid)
    n_hyp = hyp_idx.shape[1]
    s2 = _gather_points(src, hyp_idx)                         # (P, R, 2, 2)
    d2 = _gather_points(dst, hyp_idx)
    # Similarity from 2 points: the complex ratio (d1 - d0) / (s1 - s0).
    sv = s2[..., 1, :] - s2[..., 0, :]
    dv = d2[..., 1, :] - d2[..., 0, :]
    den = sv[..., 0] * sv[..., 0] + sv[..., 1] * sv[..., 1]
    den = torch.where(den < 1e-12, 1e-12, den)
    a = (dv[..., 0] * sv[..., 0] + dv[..., 1] * sv[..., 1]) / den
    b = (dv[..., 1] * sv[..., 0] - dv[..., 0] * sv[..., 1]) / den
    tx = d2[..., 0, 0] - (a * s2[..., 0, 0] - b * s2[..., 0, 1])
    ty = d2[..., 0, 1] - (b * s2[..., 0, 0] + a * s2[..., 0, 1])
    h_all = _similarity(a, b, tx, ty)                         # (P, R, 3, 3)
    proj = apply_h(h_all, src[:, None].expand(-1, n_hyp, -1, -1))
    err2 = torch.sum((proj - dst[:, None]) ** 2, dim=-1)
    inl = (err2 < thresh * thresh) & valid[:, None]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts, dim=-1)
    rows = torch.arange(p, device=src.device)
    mask = inl[rows, best]
    best_count = counts[rows, best]
    h_best = h_all[rows, best]

    # Weighted least-squares refit of (a, b, tx, ty) on the consensus.
    w = mask.to(src.dtype)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    a_mat = torch.cat([torch.stack([x, -y, one, zero], -1),
                       torch.stack([y, x, zero, one], -1)], dim=-2)
    b_vec = torch.cat([u, v], dim=-1)
    aw = a_mat * torch.cat([w, w], dim=-1)[..., None]
    ata = aw.transpose(-1, -2) @ a_mat + 1e-6 * torch.eye(
        4, dtype=src.dtype, device=src.device)
    atb = (aw.transpose(-1, -2) @ b_vec[..., None])[..., 0]
    sol = torch.linalg.solve(ata, atb)
    h_fit = _similarity(sol[:, 0], sol[:, 1], sol[:, 2], sol[:, 3])
    err2 = torch.sum((apply_h(h_fit, src) - dst) ** 2, dim=-1)
    mask_fit = (err2 < thresh * thresh) & valid
    use_fit = torch.sum(mask_fit, dim=-1) >= best_count
    h_out = torch.where(use_fit[:, None, None], h_fit, h_best)
    mask = torch.where(use_fit[:, None], mask_fit, mask)
    return h_out, mask, torch.sum(mask, dim=-1)
