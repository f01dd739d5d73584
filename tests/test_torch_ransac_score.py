"""K7 (`kernels/ransac_score.py::ransac_score_counts`): the inliers of each
RANSAC hypothesis among a pair's scoring points.

On the CPU the wrapper is its plain version, held here to the lines
`ransac_homography` ran inline before K7, and `emulate` runs the CUDA
kernel's arithmetic in numpy (its product order, fma and IEEE division)
against it.  The tests marked `cuda` hold the kernel to the plain version
on the card: equal counts on at least 99.9% of hypotheses, and a count
that differs does so by one point at most, a point whose squared error
lies within 1e-3 of the threshold's square, relative (9e-3 px^2 at 3 px:
ROADMAP fault (j)'s tolerance; one float32 step of a 3000-px projection
moves a 3-px error's square by ~1.5e-3 px^2).  This file imports no
JAX, so it runs on the card's machine as it is."""

import os

import numpy as np
import pytest
import torch

from _torch_port import cuda_device, kernel_launches, n, plain_err2
from image_stitching_tpu_torch.core import logging as log
from image_stitching_tpu_torch.core.prng import PRNGKey, split
from image_stitching_tpu_torch.kernels import ransac_score as k7
from image_stitching_tpu_torch.ops import matching, ransac
from image_stitching_tpu_torch.ops.features import Features

THRESH = 3.0
T2 = THRESH * THRESH


def inline_counts(h_all, src, dst, score_idx, thresh):
    """The scoring lines of `ransac_homography` before K7, as they were."""
    n_hyp = h_all.shape[1]
    src_s = torch.gather(src, 1, score_idx[..., None].expand(-1, -1, 2))
    dst_s = torch.gather(dst, 1, score_idx[..., None].expand(-1, -1, 2))
    proj = ransac.apply_h(h_all, src_s[:, None].expand(-1, n_hyp, -1, -1))
    err2 = torch.sum((proj - dst_s[:, None]) ** 2, dim=-1)
    return torch.sum(err2 < thresh * thresh, dim=-1)


def assert_counts_close(got, want, err2, t2=T2):
    """K7's counts against the plain ones: equal on >= 99.9% of the
    hypotheses; a count differs by one at most, and only where one of its
    points' plain squared errors lies within 1e-3 of t2, relative."""
    got, want, err2 = n(got), n(want), n(err2)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = got - want
    assert np.abs(diff).max(initial=0) <= 1, np.abs(diff).max()
    assert (diff == 0).mean() >= 0.999, (diff != 0).sum()
    near = (np.abs(err2 / t2 - 1.0) <= 1e-3).sum(-1)
    assert np.all(near[diff != 0] >= 1)


def scene(p, n_hyp, m_slots, m, seed=0, sigma=1.5):
    """Pairs of correspondences under a random homography with Gaussian
    noise and 20% outliers, hypotheses near it, and scoring indices:
    (h_all, src, dst, score_idx), many errors near (3 px)^2."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 3000, (p, m_slots, 2)).astype(np.float32)
    h_true = np.eye(3) + rng.normal(0, 1e-5, (p, 3, 3)) * [[1e3, 1e3, 1e5],
                                                            [1e3, 1e3, 1e5],
                                                            [1, 1, 0]]
    h_true[:, 0, 2] += 500
    q = np.einsum("pij,pmj->pmi", h_true, np.c_[src.reshape(-1, 2),
                                                np.ones(p * m_slots)]
                  .reshape(p, m_slots, 3))
    dst = q[..., :2] / q[..., 2:] + rng.normal(0, sigma, (p, m_slots, 2))
    out = rng.uniform(size=(p, m_slots)) < 0.2
    dst[out] = rng.uniform(0, 3000, (out.sum(), 2))
    h_all = h_true[:, None] * (1 + rng.normal(0, 2e-4, (p, n_hyp, 3, 3)))
    h_all[:, : n_hyp // 8] = rng.normal(0, 1, (p, n_hyp // 8, 3, 3))
    idx = rng.integers(0, m_slots, (p, m))
    return (torch.from_numpy(h_all.astype(np.float32)),
            torch.from_numpy(src), torch.from_numpy(dst.astype(np.float32)),
            torch.from_numpy(idx))


def emulate(h_all, src, dst, score_idx, t2=T2):
    """csrc/ransac_score.cu's counts in numpy: a row of H times (x, y, 1)
    as fma(h1, y, h0 x) + h2 (the fma as a float64 sum rounded once),
    apply_h's z guard, IEEE division, the squared error unfused; an index
    outside [0, M) is no inlier."""
    f32, f64 = np.float32, np.float64
    h = n(h_all).reshape(h_all.shape[0], h_all.shape[1], 9)
    idx = n(score_idx)
    m_slots = src.shape[1]
    ok = (idx >= 0) & (idx < m_slots)
    safe = np.where(ok, idx, 0)
    s = np.take_along_axis(n(src), safe[..., None], 1)
    d = np.take_along_axis(n(dst), safe[..., None], 1)
    x, y = s[:, None, :, 0], s[:, None, :, 1]
    u, v = d[:, None, :, 0], d[:, None, :, 1]

    def row(r):
        a0, a1, a2 = (h[:, :, 3 * r + i, None] for i in range(3))
        prod = (a0 * x).astype(f32)
        fma = (a1.astype(f64) * y.astype(f64) + prod.astype(f64)).astype(f32)
        return (fma + a2).astype(f32)
    qx, qy, z = row(0), row(1), row(2)
    z = np.where(np.abs(z) < f32(1e-12), f32(1e-12), z).astype(f32)
    dx = (qx / z - u).astype(f32)
    dy = (qy / z - v).astype(f32)
    e = (dx * dx + dy * dy).astype(f32)
    return torch.from_numpy(((e < f32(t2)) & ok[:, None]).sum(-1))


def ring_pair_features(dev):
    """Images 0 and 1 of the sigma-4 8 x 2448x3264 ring's full-resolution
    ORB features (tests/data/ring_sigma4_features.npz) on `dev`."""
    z = dict(np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "ring_sigma4_features.npz")))
    zeros = torch.zeros(z["valid"].shape[1])

    def one(i):
        return Features(xy=torch.from_numpy(z["xy"][i]), response=zeros,
                        angle=zeros, octave=zeros.to(torch.int32),
                        size=zeros, desc=torch.from_numpy(z["desc"][i]),
                        valid=torch.from_numpy(z["valid"][i]))[None]
    fa, fb = one(0), one(1)
    return tuple(Features(*(x.to(dev) for x in (
        f.xy, f.response, f.angle, f.octave, f.size, f.desc, f.valid)))
        for f in (fa, fb))


# ---- on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("p,n_hyp,m_slots,m", [(3, 512, 2000, 1024),
                                               (2, 100, 700, 700),
                                               (1, 1, 5, 5)])
def test_plain_is_the_inline_scoring(p, n_hyp, m_slots, m):
    """The plain version equals the lines it replaced bit for bit, on the
    einsum's own (strided) hypotheses and on their contiguous copy."""
    h_all, src, dst, idx = scene(p, n_hyp, m_slots, m, seed=p)
    strided = torch.einsum("pij,pnjk,pkl->pnil", torch.eye(3).repeat(p, 1, 1),
                           h_all, torch.eye(3).repeat(p, 1, 1))
    assert not strided.is_contiguous() or p * n_hyp == 1
    want = inline_counts(strided, src, dst, idx, THRESH)
    assert want.dtype == torch.int64
    assert torch.equal(k7.ransac_score_counts_plain(strided, src, dst, idx,
                                                    THRESH), want)
    assert torch.equal(k7.ransac_score_counts(strided.contiguous(), src, dst,
                                              idx, THRESH), want)


@pytest.mark.parametrize("m_slots", [300, 2600])
def test_ransac_homography_same_as_inline_scoring(monkeypatch, m_slots):
    """`ransac_homography` returns the same H, mask and inlier counts
    through `ransac_score_counts` as with the lines it ran inline, with a
    key and with injected draws, below and above 1024 scoring points."""
    _, src, dst, _ = scene(4, 8, m_slots, 8, seed=m_slots)
    valid = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(4, m_slots)) < 0.8)
    keys = split(PRNGKey(7, "cpu"), 4)
    m = min(m_slots, 1024)
    hyp = torch.from_numpy(np.random.default_rng(2).integers(
        0, m_slots, (4, 512, 4)))
    sub = torch.from_numpy(np.random.default_rng(3).integers(
        0, m_slots, (4, m)))
    got = [ransac.ransac_homography(src, dst, valid, keys),
           ransac.ransac_homography(src, dst, valid, hyp_idx=hyp,
                                    score_idx=sub)]
    monkeypatch.setattr(ransac, "ransac_score_counts", inline_counts)
    want = [ransac.ransac_homography(src, dst, valid, keys),
            ransac.ransac_homography(src, dst, valid, hyp_idx=hyp,
                                     score_idx=sub)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    assert int(got[0][2].min()) > 20


@pytest.mark.parametrize("p,n_hyp,m_slots,m", [(3, 200, 2000, 1024),
                                               (2, 64, 3000, 1500)])
def test_kernel_emulation_matches_plain(p, n_hyp, m_slots, m):
    """The kernel's arithmetic, emulated, gives the plain counts up to
    points at the threshold, the gate the card tests apply; an index
    outside [0, M) counts as no inlier."""
    h_all, src, dst, idx = scene(p, n_hyp, m_slots, m, seed=11)
    want = k7.ransac_score_counts_plain(h_all, src, dst, idx, THRESH)
    assert_counts_close(emulate(h_all, src, dst, idx), want,
                        plain_err2(h_all, src, dst, idx))
    assert int(want.max()) > m // 2
    bad = idx.clone()
    bad[:, ::2] = m_slots
    bad[:, 1::4] = -1
    assert torch.equal(emulate(h_all, src, dst, bad),
                       emulate(h_all, src, dst, idx[:, 3::4]))


def test_wrapper_checks_inputs():
    h_all, src, dst, idx = scene(2, 16, 50, 20)
    call = k7.ransac_score_counts
    with pytest.raises(TypeError):
        call(h_all.double(), src, dst, idx, THRESH)
    with pytest.raises(TypeError):
        call(h_all, src.half(), dst, idx, THRESH)
    with pytest.raises(TypeError):
        call(h_all, src, dst, idx.to(torch.int32), THRESH)
    with pytest.raises(ValueError):
        call(h_all[0], src, dst, idx, THRESH)
    with pytest.raises(ValueError):
        call(h_all, src, dst[:1], idx, THRESH)
    with pytest.raises(ValueError):
        call(h_all, src[..., :1].contiguous(), dst[..., :1].contiguous(),
             idx, THRESH)
    with pytest.raises(ValueError):
        call(h_all.transpose(-1, -2), src, dst, idx, THRESH)
    with pytest.raises(ValueError):
        call(h_all, src, dst, idx[:, ::2], THRESH)
    with pytest.raises(ValueError):
        call(h_all, src.to("meta"), dst, idx, THRESH)
    with pytest.raises(ValueError, match="no kernel"):
        call(*(x.to("meta") for x in (h_all, src, dst, idx)), THRESH)


def test_k7_span_in_ransac_homography():
    """`ransac_homography` opens one `K7` span a call, carrying the pairs,
    hypotheses and scoring points; the `ransac.k7_pairs` counter counts
    launches of the kernel alone, so the CPU leaves it out."""
    _, src, dst, _ = scene(3, 8, 1500, 8, seed=5)
    valid = torch.ones((3, 1500), dtype=torch.bool)
    with log.trace_stitch() as trace:
        ransac.ransac_homography(src, dst, valid,
                                 split(PRNGKey(1, "cpu"), 3), n_hyp=128)
    spans = [s for s in trace.spans if s.name == "K7"]
    assert [s.attrs for s in spans] == [dict(pairs=3, n_hyp=128, m=1024)]
    assert "ransac.k7_pairs" not in trace.counters


# ---- on the card ---------------------------------------------------------

CUDA_CASES = [(5, 512, 8000, 1024), (3, 100, 1600, 1500), (1, 1, 7, 7),
              (666, 512, 8000, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("p,n_hyp,m_slots,m", CUDA_CASES)
def test_kernel_matches_plain_on_cuda(p, n_hyp, m_slots, m):
    """K7 on the card against its plain version on the card, one launch a
    call, one kernel in a CUDA graph of it; the rig's block of 666 pairs
    among the shapes."""
    dev = cuda_device()
    h_all, src, dst, idx = (x.to(dev) for x in scene(p, n_hyp, m_slots, m,
                                                       seed=p + m))
    before = k7.ransac_score_counts.launches
    got = k7.ransac_score_counts(h_all, src, dst, idx, THRESH)
    torch.cuda.synchronize()
    assert k7.ransac_score_counts.launches == before + 1
    want = k7.ransac_score_counts_plain(h_all, src, dst, idx, THRESH)
    assert_counts_close(got, want, plain_err2(h_all, src, dst, idx))
    assert kernel_launches(lambda: k7.ransac_score_counts(
        h_all, src, dst, idx, THRESH)) == 1
    if m > 100:
        assert int(want.max()) > m // 2


@pytest.mark.cuda
def test_kernel_out_of_range_index_on_cuda():
    """An index outside [0, M) reads nothing and counts as no inlier."""
    dev = cuda_device()
    h_all, src, dst, idx = (x.to(dev) for x in scene(2, 128, 900, 900))
    bad = idx.clone()
    bad[:, ::2] = 900
    bad[:, 1::4] = -1
    got = k7.ransac_score_counts(h_all, src, dst, bad, THRESH)
    keep = idx[:, 3::4].contiguous()
    want = k7.ransac_score_counts(h_all, src, dst, keep, THRESH)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ring_pair_through_k7_on_cuda(monkeypatch):
    """One ring8 pair of real ORB matches (images 0 and 1 of the sigma-4
    ring, K = 4000) through `match_pairs` on the card: K7's counts on the
    hypotheses `ransac_homography` made against the plain counts, and where
    they are equal the pair's H, inlier mask and count equal the plain
    scorer's bit for bit; the counter adds the block's pairs."""
    dev = cuda_device()
    fa, fb = ring_pair_features(dev)
    key = split(PRNGKey(0, dev), 28)[:1]
    calls = []
    real = ransac.ransac_score_counts

    def watch(*args):
        out = real(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(ransac, "ransac_score_counts", watch)
    with log.trace_stitch() as trace:
        got = matching.match_pairs(fa, fb, key=key)
    torch.cuda.synchronize()
    assert trace.counters["ransac.k7_pairs"] == 1
    (h_all, src, dst, idx, thresh), counts = calls[0]
    want = k7.ransac_score_counts_plain(h_all, src, dst, idx, thresh)
    assert_counts_close(counts, want, plain_err2(h_all, src, dst, idx))
    assert int(counts.max()) > 100
    monkeypatch.setattr(ransac, "ransac_score_counts",
                        k7.ransac_score_counts_plain)
    plain = matching.match_pairs(fa, fb, key=key)
    if torch.equal(counts, want):
        for a, b in zip(got, plain):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_ties_go_to_the_lowest_index_on_cuda():
    """Copies of each pair's best hypothesis score its count on the card,
    and `argmax` keeps the first of the tied hypotheses."""
    dev = cuda_device()
    h_all, src, dst, idx = (x.to(dev) for x in scene(2, 512, 4000, 1024,
                                                       seed=3))
    best = torch.argmax(k7.ransac_score_counts(h_all, src, dst, idx,
                                               THRESH), dim=-1)
    copies = torch.tensor([9, 400, 511], device=dev)
    for p in range(2):
        h_all[p, copies] = h_all[p, best[p]].clone()
    counts = k7.ransac_score_counts(h_all, src, dst, idx, THRESH)
    rows = torch.arange(2, device=dev)
    assert torch.all(counts[:, copies] == counts[rows, best][:, None])
    assert torch.equal(counts.max(dim=-1).values, counts[rows, best])
    assert torch.equal(torch.argmax(counts, dim=-1),
                       torch.minimum(best, copies[0]))
