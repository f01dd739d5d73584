"""Exposure compensation NO / GAIN / GAIN_BLOCKS / CHANNELS /
CHANNELS_BLOCKS (port of `ops/exposure.py:64-319, 351-651`, the
`feed_device` route).

cv::detail::GainCompensator semantics: one gain system over all images
(alpha 0.01, beta 100, self-counts in the prior terms only), solved in
float64 on the host; GAIN's intensity is the L2 norm of the RGB triple,
CHANNELS solves the same system per channel.  The *_BLOCKS types
(cv::detail::BlocksCompensator) tile each seam-scale warped image into its
own block grid (ceil(size / block) blocks of ceil(size / blocks) pixels,
last block clipped), feed every block into the one system as an image of
its own, and smooth each image's gain map `nr_filtering` times with
[1 2 1] / 4 under BORDER_REFLECT_101.  GAIN and CHANNELS are the
one-block case of the same machinery.

The overlap statistics come from the padded warped stacks on the device,
as separable one-hot binning products: a pixel's block row depends on y
alone and its block column on x alone, for both images of a pair, so each
table is Y^T @ fields @ X with one-hot Y and X (float32 `torch.matmul`;
the counts are exact integers).  Only the small tables go to the host,
which maps the ranks back to block indices and assembles the system.
The fused compose applies the maps (`pipeline/compose_fused.py::
prep_gains`).

`feed` is the reference's host route, kept for the non-uniform branch:
the same statistics from host images of any sizes (the warped float
seam images), by bincounts in float64, whose numbers the reference's
non-uniform stitch reads.  `apply_gain` is the loop compose's apply:
the block map resized over each compose-scale warped image.

Both feeds trace two spans (`core/logging.py`): `exposure stats`, the
statistics (`feed_device`: on the device, up to their copy to the host;
`feed`: the bincounts and the system's assembly), and `gain solve`, the
solve and the gain maps' filter (attribute `unknowns`, the block
count).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ExposureCompensatorType as ECType
from ..core.logging import span
from .imgproc import resize
from .seams import bucket_dim, overlap_box, periodic_corner

__all__ = ["ExposureCompensator", "feed", "feed_device", "apply_gain"]

_ALPHA = 0.01
_BETA = 100.0


@dataclasses.dataclass
class ExposureCompensator:
    """Fitted gains.  NO: `gains` (N,) ones.  GAIN: (N,) and CHANNELS:
    (N, 3) float64.  GAIN_BLOCKS: (N, Gy_max, Gx_max) and
    CHANNELS_BLOCKS: (N, Gy_max, Gx_max, 3) float32, zero-padded to the
    largest grid, `grid_sizes[i] = (gy_i, gx_i)` image i's own grid (ones
    for the global types)."""
    comp_type: ECType
    gains: np.ndarray
    grid_sizes: np.ndarray  # (N, 2) int


def _block_grid(w: int, h: int, block: int) -> Tuple[int, int, int, int]:
    """(grid_w, grid_h, block_w, block_h) with OpenCV's ceil-twice
    rounding."""
    gw = (w + block - 1) // block
    gh = (h + block - 1) // block
    bw = (w + gw - 1) // gw
    bh = (h + gh - 1) // gh
    return gw, gh, bw, bh


def _block_rects(grids, sizes, corner, i):
    """Global-coord rects of image i's blocks at its effective corner."""
    gw, gh, bw, bh = grids[i]
    w, h = sizes[i]
    bx = np.arange(gw) * bw
    by = np.arange(gh) * bh
    x0 = (corner[0] + bx)[None, :].repeat(gh, 0).ravel()
    y0 = (corner[1] + by)[:, None].repeat(gw, 1).ravel()
    x1 = np.minimum(x0 + bw, corner[0] + w)
    y1 = np.minimum(y0 + bh, corner[1] + h)
    return x0, y0, x1, y1


def _assemble_pair(n_mat, i_mat, grids, sizes, ci, cj, offs, i, j, cnt,
                   si, sj):
    """One pair's (count, per-side intensity sum) tables into the global
    system, with OpenCV's max(1, countNonZero) floor on intersecting
    block rects."""
    gwi, ghi, _, _ = grids[i]
    gwj, ghj, _, _ = grids[j]
    bi, bj = gwi * ghi, gwj * ghj
    xi0, yi0, xi1, yi1 = _block_rects(grids, sizes, ci, i)
    xj0, yj0, xj1, yj1 = _block_rects(grids, sizes, cj, j)
    rect_int = ((np.minimum(xi1[:, None], xj1[None, :]) >
                 np.maximum(xi0[:, None], xj0[None, :])) &
                (np.minimum(yi1[:, None], yj1[None, :]) >
                 np.maximum(yi0[:, None], yj0[None, :])))
    npair = np.where(rect_int, np.maximum(cnt, 1.0), 0.0)
    sl_i = slice(offs[i], offs[i] + bi)
    sl_j = slice(offs[j], offs[j] + bj)
    n_mat[sl_i, sl_j] = npair
    n_mat[sl_j, sl_i] = npair.T
    denom = np.maximum(npair, 1.0)[..., None]
    i_mat[sl_i, sl_j, :] = si / denom
    i_mat[sl_j, sl_i, :] = (sj / denom).transpose(1, 0, 2)


def _solve_gain_system(n_mat: np.ndarray, i_mat: np.ndarray) -> np.ndarray:
    """One channel of the gain system over B block-images, float64:
    GainCompensator::singleFeed's A and b; dense least squares up to 512
    unknowns, a sparse LU above."""
    b_tot = n_mat.shape[0]
    eye = np.eye(b_tot, dtype=bool)
    n_off = np.where(eye, 0.0, n_mat)
    a = -2.0 * _ALPHA * i_mat * i_mat.T * n_off
    diag = (_BETA * n_mat.sum(axis=1) +
            2.0 * _ALPHA * (i_mat * i_mat * n_off).sum(axis=1))
    a[eye] = diag
    b = _BETA * n_mat.sum(axis=1)
    if b_tot <= 512:
        return np.linalg.lstsq(a, b, rcond=None)[0]
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve
    x = spsolve(sp.csc_matrix(a), b)
    # A near-singular system makes spsolve warn and return inf/NaN.
    if np.all(np.isfinite(x)):
        return x
    return np.linalg.lstsq(a, b, rcond=None)[0]


def _filter_gain_map(gmap: np.ndarray, iters: int) -> np.ndarray:
    """sepFilter2D with [0.25 0.5 0.25] on both axes, `iters` times,
    BORDER_REFLECT_101; length-1 axes are invariant."""
    for _ in range(iters):
        for ax in (0, 1):
            if gmap.shape[ax] == 1:
                continue
            pad = [(0, 0)] * gmap.ndim
            pad[ax] = (1, 1)
            p = np.pad(gmap, pad, mode="reflect")
            sl = [slice(None)] * gmap.ndim

            def at(k):
                s = list(sl)
                s[ax] = slice(k, k + gmap.shape[ax])
                return p[tuple(s)]
            gmap = 0.25 * at(0) + 0.5 * at(1) + 0.25 * at(2)
    return gmap


def _fit_gains(comp_type, n, grids, offs, b_tot, n_mat, i_mat, nr_feeds,
               nr_filtering, per_channel: bool,
               blocks: bool) -> ExposureCompensator:
    """Solve (nr_feeds rounds, each channel), then for the block types
    filter and pad the per-image gain maps; all in one `gain solve` span
    (attribute `unknowns`, the system's block count)."""
    with span("gain solve", unknowns=b_tot):
        nch = i_mat.shape[-1]
        gains = np.ones((b_tot, nch))
        for _ in range(max(1, nr_feeds)):
            i_eff = i_mat * gains[:, None, :]
            for c in range(nch):
                gains[:, c] *= _solve_gain_system(n_mat, i_eff[..., c])
        if not blocks:
            return ExposureCompensator(
                comp_type, np.asarray(gains if per_channel else gains[:, 0],
                                      np.float64), np.ones((n, 2), np.int32))
        gy_max = max(g[1] for g in grids)
        gx_max = max(g[0] for g in grids)
        out = np.zeros((n, gy_max, gx_max, nch), np.float32)
        grid_sizes = np.zeros((n, 2), np.int32)
        for i in range(n):
            gw, gh, _, _ = grids[i]
            gm = gains[offs[i]:offs[i] + gw * gh].reshape(gh, gw, nch)
            out[i, :gh, :gw] = _filter_gain_map(gm, nr_filtering)
            grid_sizes[i] = (gh, gw)
        return ExposureCompensator(
            comp_type, out if per_channel else out[..., 0], grid_sizes)


def _snap8(x: int) -> int:
    return -(-x // 8) * 8


def _rank_cap(bucket_dim_: int, block_size: int, blocks: bool) -> int:
    """Bound (incl. one spare slot) on the distinct (block_i, block_j)
    rank pairs along one axis of an overlap of at most `bucket_dim_`
    pixels: every block dim exceeds block_size / 2; one block per image
    gives one rank."""
    if not blocks:
        return 8
    bmin = block_size // 2 + 1
    return _snap8(2 * (bucket_dim_ // bmin + 2))


def _staircase(o_i: int, o_j: int, b_i: int, b_j: int, length: int):
    """Dense ranks of the (block_i, block_j) index pairs along one axis:
    (ranks (length,) int64, blk_i (n,), blk_j (n,))."""
    t = np.arange(length, dtype=np.int64)
    ri = (o_i + t) // b_i
    rj = (o_j + t) // b_j
    key = ri << 20 | rj
    uniq, inv = np.unique(key, return_inverse=True)
    return (inv.astype(np.int64), (uniq >> 20).astype(np.int64),
            (uniq & ((1 << 20) - 1)).astype(np.int64))


def _intensity(img: torch.Tensor, per_channel: bool) -> torch.Tensor:
    """(..., nch) intensities of (..., 3) pixels: the channels, or the L2
    norm of the RGB triple (GainCompensator's norm(Vec3b))."""
    img = img.to(torch.float32)
    if per_channel:
        return img
    return torch.linalg.vector_norm(img, dim=-1)[..., None]


def _self_stats_dev(stack, masks, params, gh_cap: int, gw_cap: int,
                    per_channel: bool):
    """Own-block stats of every image (`_self_stats_dev`): (N, gh_cap,
    gw_cap, 1 + nch) with [..., 0] the masked pixel counts and [..., 1:]
    the intensity sums on each image's block grid.  params (N, 5) int64
    device (gw, bw, bh, w, h)."""
    n, hp, wp = masks.shape
    dev = masks.device
    yy = torch.arange(hp, device=dev)
    xx = torch.arange(wp, device=dev)
    bw, bh, w, h = (params[:, k, None] for k in (1, 2, 3, 4))
    ymat = (((yy // bh)[..., None] == torch.arange(gh_cap, device=dev)) &
            (yy < h)[..., None]).to(torch.float32)        # (N, hp, gh_cap)
    xmat = (((xx // bw)[..., None] == torch.arange(gw_cap, device=dev)) &
            (xx < w)[..., None]).to(torch.float32)        # (N, wp, gw_cap)
    m = (masks > 0).to(torch.float32)[..., None]
    fields = torch.cat([m, m * _intensity(stack, per_channel)],
                       -1).permute(0, 3, 1, 2)            # (N, c, hp, wp)
    a = ymat.transpose(1, 2)[:, None] @ fields            # (N, c, gh, wp)
    return (a @ xmat[:, None]).permute(0, 2, 3, 1)        # (N, gh, gw, c)


def _pair_stats_dev(stack, masks, idx_i, idx_j, off_i, off_j, rect_hw,
                    py_keys, px_keys, bh_b: int, bw_b: int, py_cap: int,
                    px_cap: int, per_channel: bool):
    """Overlap stats of a bucket of T pairs (`_pair_stats_dev`): crops
    of both images at their overlap offsets, then one-hot binning products
    over the host-built staircase ranks.  Returns (T, py_cap, px_cap,
    1 + 2 nch): overlap counts, side-i and side-j intensity sums."""
    n, hp, wp = masks.shape
    dev = masks.device
    stack_p = F.pad(stack, (0, 0, 0, bw_b, 0, bh_b))
    masks_p = F.pad(masks, (0, bw_b, 0, bh_b))
    ar_h = torch.arange(bh_b, device=dev)
    ar_w = torch.arange(bw_b, device=dev)

    def gather(idx, off):
        rows = off[:, 0].clamp(0, hp)[:, None] + ar_h        # (T, bh_b)
        cols = off[:, 1].clamp(0, wp)[:, None] + ar_w        # (T, bw_b)
        sel = (idx[:, None, None], rows[:, :, None], cols[:, None, :])
        return stack_p[sel], masks_p[sel]

    img_i, msk_i = gather(idx_i, off_i)
    img_j, msk_j = gather(idx_j, off_j)
    inside = ((ar_h[None, :, None] < rect_hw[:, 0, None, None]) &
              (ar_w[None, None, :] < rect_hw[:, 1, None, None]))
    both = ((msk_i > 0) & (msk_j > 0) & inside).to(torch.float32)[..., None]
    fields = torch.cat([both, both * _intensity(img_i, per_channel),
                        both * _intensity(img_j, per_channel)],
                       -1).permute(0, 3, 1, 2)           # (T, c, bh, bw)
    ymat = (py_keys[..., None] == torch.arange(py_cap, device=dev)).to(
        torch.float32)                                   # (T, bh_b, py_cap)
    xmat = (px_keys[..., None] == torch.arange(px_cap, device=dev)).to(
        torch.float32)                                   # (T, bw_b, px_cap)
    a = ymat.transpose(1, 2)[:, None] @ fields           # (T, c, py, bw)
    return (a @ xmat[:, None]).permute(0, 2, 3, 1)       # (T, py, px, 3)


def feed_device(corners, sizes, images_dev: torch.Tensor,
                masks_dev: torch.Tensor,
                comp_type: ECType = ECType.GAIN_BLOCKS, nr_feeds: int = 1,
                nr_filtering: int = 2, block_size: int = 64,
                period=None) -> ExposureCompensator:
    """Fit the compensator from the padded warped stacks (N, Hp, Wp, 3)
    u8 / (N, Hp, Wp) u8 on the device, each image's rect at the origin;
    corners and sizes (w, h) are the seam-scale ROIs.  period: the warped
    u-axis period that couples cross-dateline pairs."""
    if isinstance(comp_type, str):
        comp_type = ECType(comp_type.lower())
    n = len(sizes)
    if comp_type == ECType.NO:
        return ExposureCompensator(comp_type, np.ones(n),
                                   np.ones((n, 2), np.int32))
    blocks = comp_type in (ECType.GAIN_BLOCKS, ECType.CHANNELS_BLOCKS)
    per_channel = comp_type in (ECType.CHANNELS, ECType.CHANNELS_BLOCKS)
    nch = 3 if per_channel else 1
    dev = masks_dev.device

    grids: List[Tuple[int, int, int, int]] = []
    offs: List[int] = []
    b_tot = 0
    for w, h in sizes:
        g = _block_grid(w, h, block_size) if blocks else (1, 1, w, h)
        grids.append(g)
        offs.append(b_tot)
        b_tot += g[0] * g[1]
    # The statistics on the device, up to their copy to the host.
    with span("exposure stats"):
        params = torch.as_tensor(
            np.asarray([(g[0], g[2], g[3], s[0], s[1])
                        for g, s in zip(grids, sizes)], np.int64), device=dev)
        hp, wp = int(masks_dev.shape[1]), int(masks_dev.shape[2])
        gh_cap = gw_cap = 8
        if blocks:
            bmin = block_size // 2 + 1
            gh_cap, gw_cap = _snap8(hp // bmin + 2), _snap8(wp // bmin + 2)
        self_pend = _self_stats_dev(images_dev, masks_dev, params, gh_cap,
                                    gw_cap, per_channel)

        buckets = {}
        for i in range(n):
            for j in range(i + 1, n):
                cj = periodic_corner(corners[i], sizes[i], corners[j],
                                     sizes[j], period)
                x, y, w, h = overlap_box(corners[i], sizes[i], cj, sizes[j])
                if w <= 0 or h <= 0:
                    continue
                buckets.setdefault((bucket_dim(h), bucket_dim(w)), []).append(
                    (i, j, y - corners[i][1], x - corners[i][0], y - cj[1],
                     x - cj[0], h, w, cj))
        pair_pend, pair_meta = [], []
        for (bh_b, bw_b), items in buckets.items():
            t = len(items)
            py_cap = _rank_cap(bh_b, block_size, blocks)
            px_cap = _rank_cap(bw_b, block_size, blocks)
            tab = np.zeros((t, 6), np.int64)
            pyk = np.zeros((t, bh_b), np.int64)
            pxk = np.zeros((t, bw_b), np.int64)
            ranks = []
            for slot, (i, j, oyi, oxi, oyj, oxj, h, w, _cj) in enumerate(
                    items):
                tab[slot] = (i, j, oyi, oxi, oyj, oxj)
                ry, ryi_u, ryj_u = _staircase(oyi, oyj, grids[i][3],
                                              grids[j][3], h)
                rx, rxi_u, rxj_u = _staircase(oxi, oxj, grids[i][2],
                                              grids[j][2], w)
                assert len(ryi_u) < py_cap and len(rxi_u) < px_cap
                pyk[slot, :h] = ry
                pxk[slot, :w] = rx
                ranks.append((ryi_u, ryj_u, rxi_u, rxj_u))
            tab_d = torch.as_tensor(tab, device=dev)
            hw_d = torch.as_tensor(np.asarray([it[6:8] for it in items],
                                              np.int64), device=dev)
            pair_pend.append(_pair_stats_dev(
                images_dev, masks_dev, tab_d[:, 0], tab_d[:, 1], tab_d[:, 2:4],
                tab_d[:, 4:6], hw_d, torch.as_tensor(pyk, device=dev),
                torch.as_tensor(pxk, device=dev), bh_b, bw_b, py_cap, px_cap,
                per_channel))
            pair_meta.append((items, ranks))

        self_tbl = self_pend.cpu().numpy().astype(np.float64)
        pair_stats = [p.cpu().numpy().astype(np.float64) for p in pair_pend]

    n_mat = np.zeros((b_tot, b_tot))
    i_mat = np.zeros((b_tot, b_tot, nch))
    for i in range(n):
        gw, gh, _, _ = grids[i]
        bi = gw * gh
        ai = offs[i] + np.arange(bi)
        tbl = self_tbl[i][:gh, :gw]
        cnt = tbl[..., 0].ravel()
        n_mat[ai, ai] = np.maximum(cnt, 1.0)
        i_mat[ai, ai, :] = (tbl[..., 1:].reshape(bi, nch) /
                            np.maximum(cnt, 1.0)[:, None])
    for (items, ranks), tbl_t in zip(pair_meta, pair_stats):
        for slot, (i, j, *rest) in enumerate(items):
            cj = rest[-1]
            bi = grids[i][0] * grids[i][1]
            bj = grids[j][0] * grids[j][1]
            ryi_u, ryj_u, rxi_u, rxj_u = ranks[slot]
            tbl = tbl_t[slot][:len(ryi_u), :len(rxi_u)]
            # Rank pair (p, q) is exactly one (block_i, block_j) pair.
            bi_g = ryi_u[:, None] * grids[i][0] + rxi_u[None, :]
            bj_g = ryj_u[:, None] * grids[j][0] + rxj_u[None, :]
            cnt = np.zeros((bi, bj))
            si = np.zeros((bi, bj, nch))
            sj = np.zeros((bi, bj, nch))
            cnt[bi_g, bj_g] = tbl[..., 0]
            si[bi_g, bj_g, :] = tbl[..., 1:1 + nch]
            sj[bi_g, bj_g, :] = tbl[..., 1 + nch:]
            _assemble_pair(n_mat, i_mat, grids, sizes, corners[i], cj,
                           offs, i, j, cnt, si, sj)
    return _fit_gains(comp_type, n, grids, offs, b_tot, n_mat, i_mat,
                      nr_feeds, nr_filtering, per_channel, blocks)


def feed(corners, images_warped, masks_warped,
         comp_type: ECType = ECType.GAIN_BLOCKS, nr_feeds: int = 1,
         nr_filtering: int = 2, block_size: int = 64,
         period=None) -> ExposureCompensator:
    """Fit the compensator from host images (h_i, w_i, 3) and masks
    (h_i, w_i) of any sizes at the seam-scale corners: self and pair
    block statistics by float64 bincounts, then the one gain system.
    period: the warped u-axis period that couples cross-dateline pairs."""
    if isinstance(comp_type, str):
        comp_type = ECType(comp_type.lower())
    n = len(images_warped)
    if comp_type == ECType.NO:
        return ExposureCompensator(comp_type, np.ones(n),
                                   np.ones((n, 2), np.int32))
    blocks = comp_type in (ECType.GAIN_BLOCKS, ECType.CHANNELS_BLOCKS)
    per_channel = comp_type in (ECType.CHANNELS, ECType.CHANNELS_BLOCKS)
    nch = 3 if per_channel else 1

    imgs = [np.asarray(im, np.float64) for im in images_warped]
    msks = [np.asarray(m) > 0 for m in masks_warped]
    sizes = [(im.shape[1], im.shape[0]) for im in imgs]
    intens = [im if per_channel else
              np.linalg.norm(im, axis=-1)[..., None] for im in imgs]
    grids: List[Tuple[int, int, int, int]] = []
    offs: List[int] = []
    b_tot = 0
    for w, h in sizes:
        g = _block_grid(w, h, block_size) if blocks else (1, 1, w, h)
        grids.append(g)
        offs.append(b_tot)
        b_tot += g[0] * g[1]
    n_mat = np.zeros((b_tot, b_tot))
    i_mat = np.zeros((b_tot, b_tot, nch))

    def block_index_map(i, x0, y0, w, h):
        """Block index of image i over local pixels [x0, x0 + w) x
        [y0, y0 + h)."""
        gw, _, bw, bh = grids[i]
        bx = (x0 + np.arange(w)) // bw
        by = (y0 + np.arange(h)) // bh
        return by[:, None] * gw + bx[None, :]

    # The statistics by bincounts, assembled into the system.
    with span("exposure stats"):
        for i in range(n):
            gw, gh, _, _ = grids[i]
            bi = gw * gh
            ai = offs[i] + np.arange(bi)
            key = block_index_map(i, 0, 0, *sizes[i])[msks[i]]
            cnt = np.bincount(key, minlength=bi).astype(np.float64)
            n_mat[ai, ai] = np.maximum(cnt, 1.0)
            for c in range(nch):
                s = np.bincount(key, weights=intens[i][..., c][msks[i]],
                                minlength=bi)
                i_mat[ai, ai, c] = s / np.maximum(cnt, 1.0)
            for j in range(i + 1, n):
                cj = periodic_corner(corners[i], sizes[i], corners[j],
                                     sizes[j], period)
                x, y, w, h = overlap_box(corners[i], sizes[i], cj, sizes[j])
                if w <= 0 or h <= 0:
                    continue
                bj = grids[j][0] * grids[j][1]
                oxi, oyi = x - corners[i][0], y - corners[i][1]
                oxj, oyj = x - cj[0], y - cj[1]
                both = (msks[i][oyi:oyi + h, oxi:oxi + w] &
                        msks[j][oyj:oyj + h, oxj:oxj + w])
                key = (block_index_map(i, oxi, oyi, w, h) * bj +
                       block_index_map(j, oxj, oyj, w, h))[both]
                cnt = np.bincount(key, minlength=bi * bj).astype(
                    np.float64).reshape(bi, bj)
                ii = intens[i][oyi:oyi + h, oxi:oxi + w]
                ij = intens[j][oyj:oyj + h, oxj:oxj + w]
                si = np.stack([np.bincount(key, weights=ii[..., c][both],
                                           minlength=bi * bj).reshape(bi, bj)
                               for c in range(nch)], -1)
                sj = np.stack([np.bincount(key, weights=ij[..., c][both],
                                           minlength=bi * bj).reshape(bi, bj)
                               for c in range(nch)], -1)
                _assemble_pair(n_mat, i_mat, grids, sizes, corners[i], cj,
                               offs, i, j, cnt, si, sj)
    return _fit_gains(comp_type, n, grids, offs, b_tot, n_mat, i_mat,
                      nr_feeds, nr_filtering, per_channel, blocks)


def apply_gain(comp: ExposureCompensator, index: int,
               img: torch.Tensor) -> torch.Tensor:
    """compensator->apply for image `index`: the (h, w, 3) image times its
    gain, its channel gains, or its block gain map resized over the image
    (cv::resize INTER_LINEAR, as BlocksCompensator::apply does)."""
    img = img.to(torch.float32)
    if comp.comp_type == ECType.NO:
        return img
    if comp.comp_type == ECType.GAIN:
        return img * float(comp.gains[index])
    gains = torch.as_tensor(np.asarray(comp.gains[index], np.float32),
                            device=img.device)
    if comp.comp_type == ECType.CHANNELS:
        return img * gains
    gh, gw = int(comp.grid_sizes[index][0]), int(comp.grid_sizes[index][1])
    gmap = resize(gains[:gh, :gw], (img.shape[0], img.shape[1]))
    return img * (gmap[..., None] if gmap.ndim == 2 else gmap)
