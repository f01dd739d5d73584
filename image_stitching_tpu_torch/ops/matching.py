"""All-pairs BestOf2Nearest matching (port of `ops/matching.py`).

For binary descriptors (ORB, AKAZE) the 2-NN of both directions of every
pair come from one call of kernel K4 (`kernels/hamming.py`,
`csrc/hamming_chunked.cu`, any K and word count) before the pairs are
chunked; on CPU tensors its plain version computes each pair's Hamming
matrix as a float32 bit-plane product, d = pop(a) + pop(b) - 2 <bits_a,
bits_b> (exact: the counts are integers below 2^24), and takes two
masked argmins per direction.  For
float descriptors (SIFT, SURF) each chunk of pairs takes its squared L2
matrices, na + nb - 2 a b^T clamped at 0 (`l2_matrix`, FLANN's squared
distances, the reference's XLA product), by one float32 matmul on the
descriptors' device, and the same two argmins.  Then the ratio test (on
squared distances for float descriptors) in both directions with
duplicate suppression; RANSAC per pair, a homography or, with
matcher_type="affine" (AffineBestOf2NearestMatcher), a similarity;
confidence n_inliers / (8 + 0.3 n_matches) with the conf > 3 -> 0
near-duplicate rule.  RANSAC takes the pairs on a leading axis in chunks
(`ransac_chunk`): on the K4 route with the homography matcher on the card,
as many pairs as `RANSAC_BYTES` holds (`ransac_pairs`: the scoring is
kernel K7 there and forms no (P, n_hyp, m) tensors); else `pair_chunk(K)`,
the plain 2-NN's budget for its (K, K) matrices.  Pair p draws from its
own threefry key, split(key, n_pairs)[p] (`core/prng.py`, the reference's
keys), so its draws do not depend on the chunk or on the pairs before it.
`match_pair` and `register_pair` are one pair's match and, from pixels,
both ORB detections (kernel K1) and the match.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.logging import span
from ..core.prng import check_key, split
from ..kernels.hamming import (hamming_matrix, hamming_two_nn_pairs,
                               pair_chunk, two_nn)
from .features.types import Features
from .ransac import ransac_affine_partial, ransac_draws, ransac_homography

# Pairs whose RANSAC uniforms one `ransac_draws` call makes in
# `match_all_pairs` (a multiple of the chunk): 179 launches a threefry
# call whatever its size, and 8 bytes an int64 word of its temporaries.
DRAW_PAIRS = 4096

# Device bytes one RANSAC block holds on the K4 route with the homography
# matcher on the card, and what a pair holds there a correspondence slot
# (353 measured on an H100 at K = 4000): match_pairs' copies of the pair's
# features and its (M,) tables, and the IRLS refit's (2M, 9) design matrix,
# its weighted copy and the two (M, 9) halves it is cut from
# (`ransac.dlt_homography`).
RANSAC_BYTES = 256 << 20
RANSAC_SLOT_BYTES = 350

__all__ = ["PairMatches", "MatchGraph", "hamming_matrix", "l2_matrix",
           "two_nn", "l2_two_nn_pairs", "match_pair", "match_pairs",
           "match_all_pairs", "register_pair", "ransac_pairs",
           "ransac_chunk"]


def ransac_pairs(m: int) -> int:
    """Pairs of M correspondence slots that one RANSAC block of the K4
    route takes: `RANSAC_BYTES` over `RANSAC_SLOT_BYTES` a slot."""
    return max(1, RANSAC_BYTES // (RANSAC_SLOT_BYTES * max(m, 1)))


def ransac_chunk(k: int, binary: bool, matcher_type: str, device) -> int:
    """Pairs a RANSAC block of `match_all_pairs` takes, for K features an
    image: `ransac_pairs(2K)` for binary descriptors (K4) with the
    homography matcher on CUDA, whose scoring (K7) forms no (P, n_hyp, m)
    tensors; else `pair_chunk(K)`, the budget of the (P, K, K) matrices
    that float descriptors' L2 2-NN builds, which also bounds the affine
    matcher's (P, n_hyp, M) scoring and the CPU's plain scoring."""
    if (binary and matcher_type != "affine"
            and torch.device(device).type == "cuda"):
        return ransac_pairs(2 * k)
    return pair_chunk(k)


def l2_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., Ka, D) x (..., Kb, D) float -> (..., Ka, Kb) SQUARED L2
    distances.  Squared on purpose: BestOf2NearestMatcher's FLANN KNN
    reports squared L2 for CV_32F descriptors and the ratio test (and the
    reference's match_conf 0.65 for SIFT and SURF) reads those."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    dots = torch.matmul(a, b.transpose(-1, -2))
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    return torch.clamp(na[..., :, None] + nb[..., None, :] - 2 * dots,
                       min=0.0)


def l2_two_nn_pairs(desc: torch.Tensor, valid: torch.Tensor,
                    ii: torch.Tensor, jj: torch.Tensor):
    """The squared-L2 2-NN of pairs (ii[p], jj[p]) of a float descriptor
    stack (N, K, D), both ways, in `hamming_two_nn_pairs`'s layout: one
    (P, K, K) matrix, read as it is forward and transposed in reverse."""
    a, b = ii.long(), jj.long()
    dist = l2_matrix(desc[a], desc[b])
    return (two_nn(dist, valid[b]),
            two_nn(dist.transpose(-1, -2), valid[a]))


@dataclasses.dataclass(frozen=True)
class PairMatches:
    """One pair's matches (cv::detail::MatchesInfo, static shapes): a_idx,
    b_idx (M,) int32 feature indices, valid and inlier (M,) bool, K
    forward then K reverse slots; h (3, 3); num_inliers and confidence
    0-d.  With a leading axis, indexing picks pairs."""

    a_idx: Any
    b_idx: Any
    valid: Any
    inlier: Any
    h: Any
    num_inliers: Any
    confidence: Any

    def __getitem__(self, idx) -> "PairMatches":
        return PairMatches(*(getattr(self, f.name)[idx]
                             for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class MatchGraph:
    """Dense (N, N) per-pair scalars plus (P, M) correspondence tables for
    the computed pairs ii[p] < jj[p] (`image_stitching_tpu` MatchGraph)."""

    ii: Any
    jj: Any
    a_idx: Any
    b_idx: Any
    valid: Any
    inlier: Any
    h: Any
    num_inliers: Any
    confidence: Any
    num_matches: Any

    def numpy(self) -> "MatchGraph":
        return MatchGraph(*(np.asarray(getattr(self, f.name).detach().cpu())
                            if isinstance(getattr(self, f.name), torch.Tensor)
                            else np.asarray(getattr(self, f.name))
                            for f in dataclasses.fields(self)))

    def subset(self, indices) -> "MatchGraph":
        """Host-side re-index onto ascending `indices` (numpy leaves)."""
        idx = np.asarray(indices)
        inv = np.full(self.confidence.shape[0], -1, np.int64)
        inv[idx] = np.arange(len(idx))
        ii, jj = np.asarray(self.ii), np.asarray(self.jj)
        keep = (inv[ii] >= 0) & (inv[jj] >= 0)
        sub = np.ix_(idx, idx)
        return MatchGraph(
            ii=inv[ii[keep]].astype(np.int32),
            jj=inv[jj[keep]].astype(np.int32),
            a_idx=np.asarray(self.a_idx)[keep],
            b_idx=np.asarray(self.b_idx)[keep],
            valid=np.asarray(self.valid)[keep],
            inlier=np.asarray(self.inlier)[keep],
            h=np.asarray(self.h)[sub],
            num_inliers=np.asarray(self.num_inliers)[sub],
            confidence=np.asarray(self.confidence)[sub],
            num_matches=np.asarray(self.num_matches)[sub])


def match_pairs(fa: Features, fb: Features, match_conf: float = 0.32,
                key=None, n_hyp: int = 512, hyp_idx=None,
                score_idx=None, nn=None, matcher_type: str = "homography",
                draws=None):
    """BestOf2NearestMatcher::match for a batch of pairs (leading axis P).

    key: the pairs' threefry keys (P, 2), the RANSAC draws; or `draws`,
    the uniforms `ops/ransac.py::ransac_draws` gives for them.
    nn: the pairs' (fwd, rev) 2-NN as `hamming_two_nn_pairs` (or, for float
    descriptors, `l2_two_nn_pairs`) returns them; computed here when not
    given.  hyp_idx/score_idx: injected RANSAC draws in place of the
    key's (the affine matcher takes no scoring indices).  Returns (a_idx,
    b_idx, valid, inlier (P, 2K), h (P, 3, 3), num_inliers (P,),
    confidence (P,)): K forward then K reverse slots."""
    p, ka = fa.valid.shape
    kb = fb.valid.shape[1]
    dev = fa.xy.device
    if nn is None:
        idx = torch.arange(p, dtype=torch.int32, device=dev)
        two_nn_pairs = (l2_two_nn_pairs if torch.is_floating_point(fa.desc)
                        else hamming_two_nn_pairs)
        nn = two_nn_pairs(torch.cat([fa.desc, fb.desc]),
                          torch.cat([fa.valid, fb.valid]), idx, idx + p)
    (b1, d1, _, d2), (a1, rd1, _, rd2) = nn
    fwd_ok = (d1 < (1.0 - match_conf) * d2) & fa.valid
    rev_ok = (rd1 < (1.0 - match_conf) * rd2) & fb.valid
    ar_b = torch.arange(kb, device=dev).expand(p, -1)
    dup = torch.gather(fwd_ok, 1, a1) & (torch.gather(b1, 1, a1) == ar_b)
    rev_ok = rev_ok & ~dup
    a_idx = torch.cat([torch.arange(ka, device=dev).expand(p, -1), a1], 1)
    b_idx = torch.cat([b1, ar_b], 1)
    valid = torch.cat([fwd_ok, rev_ok], 1)
    src = torch.gather(fa.xy, 1, a_idx[..., None].expand(-1, -1, 2))
    dst = torch.gather(fb.xy, 1, b_idx[..., None].expand(-1, -1, 2))
    n_matches = torch.sum(valid, dim=-1)
    if matcher_type == "affine":
        h, inlier, n_inl = ransac_affine_partial(src, dst, valid, key,
                                                 n_hyp=n_hyp, hyp_idx=hyp_idx,
                                                 draws=draws)
    else:
        h, inlier, n_inl = ransac_homography(src, dst, valid, key,
                                             n_hyp=n_hyp, hyp_idx=hyp_idx,
                                             score_idx=score_idx, draws=draws)
    enough = n_matches >= 6
    conf = torch.where(enough, n_inl.to(torch.float32) /
                       (8.0 + 0.3 * n_matches.to(torch.float32)), 0.0)
    conf = torch.where(conf > 3.0, 0.0, conf)
    inlier = inlier & enough[:, None]
    h = torch.where(enough[:, None, None], h,
                    torch.eye(3, dtype=h.dtype, device=dev))
    return (a_idx.to(torch.int32), b_idx.to(torch.int32), valid, inlier, h,
            torch.where(enough, n_inl, 0).to(torch.int32), conf)


def match_all_pairs(feats: Features, key: torch.Tensor,
                    match_conf: float = 0.32, n_hyp: int = 512,
                    range_width: int = -1, pair_cap: int = -1,
                    matcher_type: str = "homography") -> MatchGraph:
    """All pairs i < j (within `range_width` when > 0) of stacked
    Features (N, K, ...); lower triangle mirrored with inverted H.

    key: one threefry key (2,) (`core/prng.py::PRNGKey`); pair p of the
    pairs kept draws from split(key, n_pairs)[p], as in the reference,
    the uniforms of up to DRAW_PAIRS pairs in one `ransac_draws`.

    pair_cap: cap M on correspondence slots per pair; valid matches are
    compacted to the front first, so only matches beyond M drop."""
    n, k = feats.xy.shape[0], feats.xy.shape[1]
    dev = feats.xy.device
    iu, ju = np.triu_indices(n, 1)
    if range_width > 0:
        keep = (ju - iu) < range_width
        iu, ju = iu[keep], ju[keep]
    m_slots = 2 * k if pair_cap <= 0 else min(pair_cap, 2 * k)
    ii = torch.as_tensor(iu, dtype=torch.int32, device=dev)
    jj = torch.as_tensor(ju, dtype=torch.int32, device=dev)
    check_key(key, ())
    keys = split(key.to(dev), len(iu))
    k_hyp, m_score = ((2, 0) if matcher_type == "affine"
                      else (4, min(2 * k, 1024)))
    binary = not torch.is_floating_point(feats.desc)
    if binary:
        with span("K4", n=n, k=k, w=feats.desc.shape[2], pairs=len(iu)):
            fwd, rev = hamming_two_nn_pairs(feats.desc, feats.valid, ii, jj)
    outs = []
    chunk = ransac_chunk(k, binary, matcher_type, dev)
    block = chunk * max(1, DRAW_PAIRS // chunk)
    for s in range(0, len(iu), chunk):
        cut = slice(s, s + chunk)
        with span("ransac block"):
            if s % block == 0:
                u_hyp, u_score = ransac_draws(keys[s:s + block], n_hyp,
                                              k_hyp, m_score)
            rows = slice(s % block, s % block + chunk)
            if binary:
                nn = (tuple(x[cut] for x in fwd),
                      tuple(x[cut] for x in rev))
            else:
                nn = l2_two_nn_pairs(feats.desc, feats.valid, ii[cut],
                                     jj[cut])
            outs.append(match_pairs(
                feats[ii[cut]], feats[jj[cut]], match_conf, n_hyp=n_hyp,
                nn=nn, matcher_type=matcher_type,
                draws=(u_hyp[rows],
                       None if u_score is None else u_score[rows])))
    if outs:
        a_idx, b_idx, valid, inlier, h_p, ninl_p, conf_p = (
            torch.cat(x) for x in zip(*outs))
    else:
        a_idx = b_idx = torch.zeros((0, 2 * k), dtype=torch.int32, device=dev)
        valid = inlier = torch.zeros((0, 2 * k), dtype=torch.bool, device=dev)
        h_p = torch.zeros((0, 3, 3), device=dev)
        ninl_p = torch.zeros((0,), dtype=torch.int32, device=dev)
        conf_p = torch.zeros((0,), device=dev)
    num_matches = torch.sum(valid, dim=-1).to(torch.int32)
    if m_slots < 2 * k:
        order = torch.argsort((~valid).to(torch.uint8), dim=-1,
                              stable=True)[:, :m_slots]
        a_idx, b_idx, valid, inlier = (torch.gather(x, 1, order)
                                       for x in (a_idx, b_idx, valid, inlier))

    def scat(x):
        out = torch.zeros((n, n) + x.shape[1:], dtype=x.dtype, device=dev)
        out[ii.long(), jj.long()] = x
        return out
    h_u, conf_u, ninl_u, nm_u = (scat(x) for x in (h_p, conf_p, ninl_p,
                                                   num_matches))
    eye = torch.eye(3, dtype=h_u.dtype, device=dev)
    hm = h_u.transpose(0, 1)
    h_ok = ((conf_u.t() > 0.0)
            & torch.all(torch.isfinite(hm), dim=(-2, -1))
            & (torch.abs(torch.linalg.det(hm)) > 1e-12))
    h_safe = torch.where(h_ok[..., None, None], hm, eye)
    h_lo = torch.where(h_ok[..., None, None], torch.linalg.inv(h_safe), eye)
    tri = (torch.arange(n, device=dev)[:, None] <
           torch.arange(n, device=dev)[None, :])
    return MatchGraph(
        ii=ii, jj=jj, a_idx=a_idx,
        b_idx=b_idx, valid=valid, inlier=inlier,
        h=torch.where(tri[..., None, None], h_u, h_lo),
        num_inliers=torch.where(tri, ninl_u, ninl_u.t()),
        confidence=torch.where(tri, conf_u, conf_u.t()),
        num_matches=torch.where(tri, nm_u, nm_u.t()))


def match_pair(feat_a: Features, feat_b: Features, key: torch.Tensor,
               match_conf: float = 0.32, matcher_type: str = "homography",
               n_hyp: int = 512) -> PairMatches:
    """BestOf2NearestMatcher::match for one pair of (K, ...) Features:
    `match_pairs` with one pair, its 2-NN by K4 (binary descriptors) or
    the squared L2 product (float ones), its RANSAC draws from the
    threefry key (2,).  Returns 2K match slots."""
    out = match_pairs(feat_a[None], feat_b[None], match_conf,
                      check_key(key, ())[None], n_hyp,
                      matcher_type=matcher_type)
    return PairMatches(*out)[0]


def register_pair(img_a: torch.Tensor, img_b: torch.Tensor,
                  key: torch.Tensor, n_features: int = 1500,
                  match_conf: float = 0.32, matcher_type: str = "homography",
                  n_hyp: int = 512) -> PairMatches:
    """Pixels to PairMatches: ORB on both (H, W) gray images (one K1
    launch each), then `match_pair` with the threefry key (2,)."""
    from .features.orb import orb_detect_and_describe
    fa = orb_detect_and_describe(img_a, n_features=n_features)
    fb = orb_detect_and_describe(img_b, n_features=n_features)
    return match_pair(fa, fb, key, match_conf, matcher_type, n_hyp)
