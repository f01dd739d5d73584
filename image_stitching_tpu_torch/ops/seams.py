"""Seam finders: "no", "voronoi", the DP colour finders and the graph-cut
finders (port of `ops/seams.py`).

DpSeamFinder(COLOR / COLOR_GRAD) semantics as the reference implements
them: every connected component of a pair's overlap gets its own seam;
the component crop is canonicalised (transposed so the seam runs down
rows, the owning sides from the centroids of the two images' exclusive
regions around it); all components of all pairs run as a few batched
dynamic programs, one per half-octave (H, W) bucket, on the device; the
partitions are then applied on the host in pair order against the
evolving masks, which keeps triple overlaps hole-free.  Pixel cost is
|I1 - I2| over RGB (+ |grad1 - grad2| for COLOR_GRAD).  strict=True runs
OpenCV's order instead: each pair's components are labelled from the
evolved masks and its DPs run before the next pair is examined.

VORONOI gives each overlap pixel to the image whose exclusive region is
nearer (exact squared EDTs by the native runtime's O(HW) transform; the
vectorised `_distance_sq` is its plain twin for the tests).  GC_COLOR
(+GRAD) cuts each overlap exactly by scipy's max-flow on the host, over
the DP cost of the pair's overlap box, computed on the device for every
overlapping pair and downloaded once; the cuts run in pair order against
the evolving masks.

The crop content is gathered from the device-resident padded warped stack
(the reference's `images_dev` route); only the masks live on the host,
where components are labelled with scipy.ndimage.  The reference's
`lax.scan` over rows is a Python loop over the rows of a bucket's batched
(T, H, W) cost on the device; the backtrack is a reverse loop on the host
over the downloaded accumulated cost.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.logging import count, span

__all__ = ["bucket_dim", "overlap_box", "periodic_corner", "find_seams",
           "edt_sq"]

_BIG = 1e9


def bucket_dim(x: int, lo: int = 16) -> int:
    """Next size >= x from the half-octave series {2^k, 1.5 * 2^k}."""
    b = lo
    while b < x:
        if b + (b >> 1) >= x:
            return b + (b >> 1)
        b <<= 1
    return b


def overlap_box(c1, s1, c2, s2) -> Tuple[int, int, int, int]:
    """Intersection rect (x, y, w, h) of two (corner, size) rois."""
    x = max(c1[0], c2[0])
    y = max(c1[1], c2[1])
    x2 = min(c1[0] + s1[0], c2[0] + s2[0])
    y2 = min(c1[1] + s1[1], c2[1] + s2[1])
    return (x, y, max(0, x2 - x), max(0, y2 - y))


def periodic_corner(c1, s1, c2, s2, period):
    """Corner of roi 2 for pairing against roi 1 on a periodic u axis: c2
    shifted by the period multiple (-1, 0, +1) that maximises the overlap
    (cross-dateline pairs of a full ring)."""
    if not period:
        return c2

    def area(c2s):
        b = overlap_box(c1, s1, c2s, s2)
        return b[2] * b[3]

    best, best_a = c2, area(c2)
    for sh in (-period, period):
        c2s = (c2[0] + sh, c2[1])
        a = area(c2s)
        if a > best_a:
            best, best_a = c2s, a
    return best


def _crop(arr: np.ndarray, corner, box):
    x, y, w, h = box
    ox, oy = x - corner[0], y - corner[1]
    return arr[oy:oy + h, ox:ox + w]


def _pair_overlap(i, j, corners, masks, sizes, period):
    """(cj, box, m1, m2) of pair i < j: j's corner for the pairing, the
    overlap box and both masks cropped to it as bool; None when the masks
    do not meet inside the box."""
    cj = periodic_corner(corners[i], sizes[i], corners[j], sizes[j], period)
    box = overlap_box(corners[i], sizes[i], cj, sizes[j])
    if box[2] <= 0 or box[3] <= 0:
        return None
    m1 = _crop(masks[i], corners[i], box) > 0
    m2 = _crop(masks[j], cj, box) > 0
    if not (m1 & m2).any():
        return None
    return cj, box, m1, m2


def _dp_seam_cost(img1: torch.Tensor, img2: torch.Tensor,
                  grad: bool = False) -> torch.Tensor:
    """(..., H, W, 3) float32 pair -> (..., H, W) seam cost."""
    d = torch.sqrt(torch.sum((img1 - img2) ** 2, dim=-1) + 1e-12)
    if grad:
        def g(a):
            gy = torch.abs(torch.diff(a, dim=-3, prepend=a[..., :1, :, :]))
            gx = torch.abs(torch.diff(a, dim=-2, prepend=a[..., :, :1, :]))
            return torch.sum(gy + gx, dim=-1)
        d = d + torch.abs(g(img1) - g(img2))
    return d


def _dp_accumulate(cost: torch.Tensor) -> torch.Tensor:
    """Row-by-row min-plus DP of a (T, H, W) cost: acc[r] = cost[r] +
    min(acc[r-1][c-1], acc[r-1][c], acc[r-1][c+1]), 1e9 beyond the edges
    (`_dp_seam`'s `lax.scan` step)."""
    acc = torch.empty_like(cost)
    prev = cost[:, 0]
    acc[:, 0] = prev
    for r in range(1, cost.shape[1]):
        left = F.pad(prev[:, :-1], (1, 0), value=_BIG)
        right = F.pad(prev[:, 1:], (0, 1), value=_BIG)
        best = torch.minimum(prev, torch.minimum(left, right))
        prev = cost[:, r] + best
        acc[:, r] = prev
    return acc


def _dp_backtrack(acc: np.ndarray) -> np.ndarray:
    """Seam column per row (T, H) from the accumulated cost: the bottom
    row's argmin, then the lowest of the three predecessors row by row
    (first minimum on ties, as argmin)."""
    t, h, w = acc.shape
    cols = np.empty((t, h), np.int64)
    col = np.argmin(acc[:, -1], axis=1)
    cols[:, -1] = col
    ar = np.arange(t)
    for r in range(h - 2, -1, -1):
        cand = np.stack([np.maximum(col - 1, 0), col,
                         np.minimum(col + 1, w - 1)], 1)
        vals = acc[:, r][ar[:, None], cand]
        col = cand[ar, np.argmin(vals, axis=1)]
        cols[:, r] = col
    return cols


def _dp_seam_batch_dev(stack, idx_i, idx_j, off_i, off_j, valid, prefer1,
                       hw, grad: bool, transpose: bool) -> np.ndarray:
    """One bucket of canonicalised component crops (`_dp_seam_batch_dev`
    with `_dp_seam_batch_core` and `_dp_seam`): gather both images' crops
    from the padded stack (clipped at its edges), wall off padded columns
    of real rows, run the DP.  valid (T, bh, bw) bool, prefer1 (T,) bool,
    hw (T, 2) real crop dims, offsets (T, 2) (row, col) in untransposed
    image coordinates, all device tensors.  Returns keep1 (T, bh, bw)
    bool on the host."""
    t, bh, bw = valid.shape
    gh, gw = (bw, bh) if transpose else (bh, bw)
    hp, wp = stack.shape[1], stack.shape[2]
    dev = stack.device

    def gather(idx, off):
        rows = (off[:, 0, None] + torch.arange(gh, device=dev)).clamp(
            0, hp - 1)
        cols = (off[:, 1, None] + torch.arange(gw, device=dev)).clamp(
            0, wp - 1)
        sub = stack[idx[:, None, None], rows[:, :, None], cols[:, None, :]]
        sub = sub.to(torch.float32)
        return sub.transpose(1, 2) if transpose else sub

    a, b = gather(idx_i, off_i), gather(idx_j, off_j)
    real_row = torch.arange(bh, device=dev)[None, :, None] < hw[:, 0, None,
                                                                None]
    real_col = torch.arange(bw, device=dev)[None, None, :] < hw[:, 1, None,
                                                                None]
    wall = real_row & ~real_col
    a = torch.where(wall[..., None], 1e4, a)
    b = torch.where(wall[..., None], -1e4, b)
    cost = torch.where(valid | wall, _dp_seam_cost(a, b, grad), 0.0)
    cols = _dp_backtrack(_dp_accumulate(cost).cpu().numpy())
    keep_left = np.arange(bw)[None, None, :] <= cols[:, :, None]
    pref = prefer1.cpu().numpy()[:, None, None]
    return np.where(pref, keep_left, ~keep_left)


def _run_dp_tasks(tasks, grad: bool, images_dev: torch.Tensor):
    """All component DPs, one batched program per (H, W, transposed)
    bucket of half-octave dims (`_run_dp_tasks`, device-sourced route).
    The bucket dims matter: padded rows spread the accumulated minimum,
    and the argmin picks among the ties they make."""
    out = [None] * len(tasks)
    groups = {}
    for idx, t in enumerate(tasks):
        h, w = t["vc"].shape
        groups.setdefault((bucket_dim(h), bucket_dim(w), not t["horiz"]),
                          []).append(idx)
    dev = images_dev.device
    for (bh, bw, transpose), idxs in groups.items():
        n = len(idxs)
        with span("dp batch", n=n, bh=bh, bw=bw):
            vv = np.zeros((n, bh, bw), bool)
            tab = np.zeros((n, 8), np.int64)   # i, j, off_i, off_j, h, w
            pl = np.zeros((n,), bool)
            for slot, idx in enumerate(idxs):
                t = tasks[idx]
                h, w = t["vc"].shape
                vv[slot, :h, :w] = t["vc"]
                pl[slot] = t["prefer1"]
                tab[slot] = (t["i"], t["j"], *t["off_i"], *t["off_j"], h, w)
            tab_d = torch.as_tensor(tab, device=dev)
            keep = _dp_seam_batch_dev(
                images_dev, tab_d[:, 0], tab_d[:, 1], tab_d[:, 2:4],
                tab_d[:, 4:6], torch.as_tensor(vv, device=dev),
                torch.as_tensor(pl, device=dev), tab_d[:, 6:8], grad,
                transpose)
            for slot, idx in enumerate(idxs):
                h, w = tasks[idx]["vc"].shape
                out[idx] = keep[slot, :h, :w]
    return out


def _dp_pair_tasks(i, j, corners, masks_src, sizes, period):
    """Component-DP tasks of one pair against `masks_src` (the initial
    masks, or the evolved ones in strict mode)."""
    import scipy.ndimage as ndi

    pair = _pair_overlap(i, j, corners, masks_src, sizes, period)
    if pair is None:
        return []
    cj, box, m1, m2 = pair
    ov = m1 & m2
    excl1 = m1 & ~m2
    excl2 = m2 & ~m1
    lab, n_comp = ndi.label(ov)
    tasks = []
    for c, sl in enumerate(ndi.find_objects(lab, n_comp), start=1):
        if sl is None:
            continue
        comp = lab[sl] == c
        y0, y1 = sl[0].start, sl[0].stop
        x0, x1 = sl[1].start, sl[1].stop
        bh, bw = y1 - y0, x1 - x0
        # Source/sink sides: centroids of each image's exclusive region
        # in a window around the component; the warped-ROI centres when
        # an exclusive side is empty.
        wy0 = max(0, y0 - max(8, bh // 2))
        wy1 = min(box[3], y1 + max(8, bh // 2))
        wx0 = max(0, x0 - max(8, bw // 2))
        wx1 = min(box[2], x1 + max(8, bw // 2))

        def _centroid(excl, fallback):
            e = excl[wy0:wy1, wx0:wx1]
            if e.any():
                ys, xs = np.nonzero(e)
                return float(xs.mean() + wx0), float(ys.mean() + wy0)
            return fallback
        fb1 = (corners[i][0] + sizes[i][0] * 0.5 - box[0],
               corners[i][1] + sizes[i][1] * 0.5 - box[1])
        fb2 = (cj[0] + sizes[j][0] * 0.5 - box[0],
               cj[1] + sizes[j][1] * 0.5 - box[1])
        cx1, cy1 = _centroid(excl1, fb1)
        cx2, cy2 = _centroid(excl2, fb2)
        horiz = abs(cx1 - cx2) * bh >= abs(cy1 - cy2) * bw
        if horiz:
            vc, prefer1 = comp, cx1 <= cx2
        else:
            vc, prefer1 = comp.T, cy1 <= cy2
        # Crop offsets in each image's local (roi-anchored) coords.
        off_i = (box[1] - corners[i][1] + y0, box[0] - corners[i][0] + x0)
        off_j = (box[1] - cj[1] + y0, box[0] - cj[0] + x0)
        tasks.append(dict(i=i, j=j, box=box, sl=sl, comp=comp, horiz=horiz,
                          prefer1=prefer1, vc=vc, cj=cj, off_i=off_i,
                          off_j=off_j))
    return tasks


def _apply_dp_partitions(tasks, keep1_all, masks, corners):
    """Apply component partitions in pair order against the evolving
    masks: a pixel surrendered to an earlier pair is out of play."""
    for t, keep1 in zip(tasks, keep1_all):
        if not t["horiz"]:
            keep1 = keep1.T
        i, j, (x, y, w, h), sl, comp = (t["i"], t["j"], t["box"], t["sl"],
                                        t["comp"])
        oyi = y - corners[i][1] + sl[0].start
        oxi = x - corners[i][0] + sl[1].start
        oyj = y - t["cj"][1] + sl[0].start
        oxj = x - t["cj"][0] + sl[1].start
        ch, cw = comp.shape
        sub_i = masks[i][oyi:oyi + ch, oxi:oxi + cw]
        sub_j = masks[j][oyj:oyj + ch, oxj:oxj + cw]
        ov_now = (sub_i > 0) & (sub_j > 0) & comp
        sub_i[ov_now & ~keep1] = 0
        sub_j[ov_now & keep1] = 0


def _find_seams_dp(corners, masks, sizes, grad: bool, images_dev,
                   period=None, strict: bool = False):
    """Label every pair overlap's components on the initial masks, run
    all their DPs batched, apply the partitions in pair order
    (`_find_seams_dp`).  strict: pair by pair, each labelled from the
    masks the earlier pairs left.  Spans: `seam overlaps` (the pair
    pass; in strict mode one a pair), `dp batch` (one a bucket, from
    `_run_dp_tasks`), `seam apply`; the counter `seams.tasks` counts the
    DP tasks cut."""
    n = len(masks)
    if strict:
        for i in range(n):
            for j in range(i + 1, n):
                with span("seam overlaps"):
                    tasks = _dp_pair_tasks(i, j, corners, masks, sizes,
                                           period)
                count("seams.tasks", len(tasks))
                if tasks:
                    keep1_all = _run_dp_tasks(tasks, grad, images_dev)
                    with span("seam apply"):
                        _apply_dp_partitions(tasks, keep1_all, masks,
                                             corners)
        return masks
    with span("seam overlaps"):
        masks0 = [m.copy() for m in masks]
        tasks = []
        for i in range(n):
            for j in range(i + 1, n):
                tasks.extend(_dp_pair_tasks(i, j, corners, masks0, sizes,
                                            period))
    count("seams.tasks", len(tasks))
    keep1_all = _run_dp_tasks(tasks, grad, images_dev)
    with span("seam apply"):
        _apply_dp_partitions(tasks, keep1_all, masks, corners)
    return masks


def _distance_sq(mask: torch.Tensor) -> torch.Tensor:
    """Squared EDT to the nearest zero of `mask` (H, W): the reference's
    vectorised O(n^2)-per-line transform, columns then rows, 1e12 for
    the set pixels; the plain twin of `edt_sq`."""
    f = torch.where(mask > 0, 1e12, 0.0)

    def edt_1d(g):       # along the last axis: min_j (i - j)^2 + g[j]
        idx = torch.arange(g.shape[-1], dtype=torch.float32,
                           device=g.device)
        return torch.min(g[..., None, :] + (idx[:, None] - idx[None, :]) ** 2,
                         dim=-1).values
    return edt_1d(edt_1d(f.t()).t())


def edt_sq(mask: np.ndarray) -> np.ndarray:
    """Exact squared EDT to the nearest zero pixel of `mask`, by the native
    runtime (which raises when it neither loads nor builds)."""
    from ..core import native
    return native.edt_sq(np.asarray(mask))


def _graph_cut_pair(cost: np.ndarray, must1: np.ndarray, must2: np.ndarray,
                    valid: np.ndarray) -> np.ndarray:
    """Exact min-cut partition of the overlap grid by scipy's max-flow
    (`_graph_cut_pair`): edge weights the integer-scaled mean endpoint
    cost, must1/must2 tied to source/sink at 2^30 (scipy casts
    capacities to int32); keep1 is the residual graph's source side.
    Returns keep1 (H, W) bool."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow

    h, w = cost.shape
    n = h * w
    src, dst = n, n + 1
    idx = np.arange(n).reshape(h, w)
    ecost = np.maximum((cost * 255.0).astype(np.int64), 1)
    rows, cols, caps = [], [], []
    for (du, dv) in ((0, 1), (1, 0)):
        u = idx[: h - du, : w - dv]
        v = idx[du:, dv:]
        c = ((ecost[: h - du, : w - dv] + ecost[du:, dv:]) // 2 + 1)
        ok = valid[: h - du, : w - dv] & valid[du:, dv:]
        uu, vv, cc = u[ok], v[ok], c[ok]
        rows.append(np.concatenate([uu, vv]))
        cols.append(np.concatenate([vv, uu]))
        caps.append(np.concatenate([cc, cc]))
    inf = int(1 << 30)
    p1 = idx[must1 & valid]
    p2 = idx[must2 & valid]
    rows.append(np.full(len(p1), src, np.int64))
    cols.append(p1.astype(np.int64))
    caps.append(np.full(len(p1), inf, np.int64))
    rows.append(p2.astype(np.int64))
    cols.append(np.full(len(p2), dst, np.int64))
    caps.append(np.full(len(p2), inf, np.int64))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    caps = np.concatenate(caps)
    if len(caps) == 0:
        return np.ones((h, w), bool)
    m = csr_matrix((caps, (rows, cols)), shape=(n + 2, n + 2))
    res = maximum_flow(m, src, dst)
    # Saturated edges are explicit zeros in the residual, and csgraph walks
    # explicit zeros: drop them before the BFS.
    resid = m - res.flow
    resid.data = np.maximum(resid.data, 0)
    resid.eliminate_zeros()
    reach = breadth_first_order(resid, src, directed=True,
                                return_predecessors=False)
    keep1 = np.zeros(n + 2, bool)
    keep1[reach] = True
    return keep1[:n].reshape(h, w)


def _gc_costs(corners, masks, sizes, grad: bool, images_dev, period):
    """The DP cost (H, W) of every overlapping pair's box, keyed (i, j):
    computed on the device from the padded stack (both crops gathered at
    the box), downloaded in one transfer.  Pairs whose initial masks do
    not meet are skipped: masks only shrink."""
    pend = []
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            pair = _pair_overlap(i, j, corners, masks, sizes, period)
            if pair is None:
                continue
            cj, (x, y, w, h) = pair[:2]
            oyi, oxi = y - corners[i][1], x - corners[i][0]
            oyj, oxj = y - cj[1], x - cj[0]
            a = images_dev[i, oyi:oyi + h, oxi:oxi + w].to(torch.float32)
            b = images_dev[j, oyj:oyj + h, oxj:oxj + w].to(torch.float32)
            pend.append(((i, j), _dp_seam_cost(a, b, grad)))
    if not pend:
        return {}
    flat = torch.cat([c.reshape(-1) for _, c in pend]).cpu().numpy()
    out, at = {}, 0
    for key, c in pend:
        out[key] = flat[at:at + c.numel()].reshape(c.shape)
        at += c.numel()
    return out


def find_seams(corners: Sequence[Tuple[int, int]],
               masks: Sequence[np.ndarray], seam_type: str = "dp_color",
               images_dev: torch.Tensor = None, period=None,
               strict: bool = False) -> List[np.ndarray]:
    """seam_finder->find: the updated masks (u8 copies).  seam_type in
    {no, voronoi, dp_color, dp_colorgrad, gc_color, gc_colorgrad}; unknown
    types raise.  The DP and graph-cut finders take their content from
    `images_dev`, the padded warped stack (N, Hp, Wp, 3) with each
    image's rect at the origin (the reference's host-image argument has no
    counterpart: the port seams from the device stack only).  period: the
    warped u-axis period, for cross-dateline pairs.  strict (DP finders):
    OpenCV's sequential order, pair by pair."""
    known = {"no", "voronoi", "dp_color", "dp_colorgrad", "gc_color",
             "gc_colorgrad"}
    if seam_type not in known:
        raise ValueError(
            f"Can't create the following seam finder '{seam_type}'")
    masks = [np.asarray(m).copy().astype(np.uint8) for m in masks]
    if seam_type == "no":
        return masks
    if images_dev is None and seam_type != "voronoi":
        raise ValueError(f"seam finder '{seam_type}' needs the device "
                         "stack images_dev")
    sizes = [(m.shape[1], m.shape[0]) for m in masks]
    grad = seam_type.endswith("colorgrad")
    if seam_type.startswith("dp"):
        return _find_seams_dp(corners, masks, sizes, grad, images_dev,
                              period, strict)
    gc_costs = (_gc_costs(corners, masks, sizes, grad, images_dev, period)
                if seam_type.startswith("gc") else {})
    n = len(masks)
    for i in range(n):
        for j in range(i + 1, n):
            pair = _pair_overlap(i, j, corners, masks, sizes, period)
            if pair is None:
                continue
            cj, box, m1, m2 = pair
            ov = m1 & m2
            if seam_type == "voronoi":
                # Nearer exclusive region wins (ties to image i).
                keep1 = edt_sq(~(m1 & ~m2)) <= edt_sq(~(m2 & ~m1))
            else:
                keep1 = _graph_cut_pair(gc_costs[(i, j)], m1 & ~m2,
                                        m2 & ~m1, ov)
            x, y, w, h = box
            oxi, oyi = x - corners[i][0], y - corners[i][1]
            oxj, oyj = x - cj[0], y - cj[1]
            sub_i = masks[i][oyi:oyi + h, oxi:oxi + w]
            sub_j = masks[j][oyj:oyj + h, oxj:oxj + w]
            sub_i[ov & ~keep1] = 0
            sub_j[ov & keep1] = 0
    return masks
