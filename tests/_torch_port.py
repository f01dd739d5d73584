"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and go through the JAX
reference on the CPU (as its own tests run it) and through the port on CPU
tensors.  torch gets one thread: the suite runs under several xdist
workers, and torch's default thread count would oversubscribe the cores.

The card's gates live here too: `kernel_launches` and `check_k1` ..
`check_k7` hold a hand kernel to its plain version on the card, for the
`cuda`-marked tests and for `chip_smoke.py`.  Imports nothing of JAX at
module level.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def t(a, dtype=None):
    """numpy (or jax) array -> CPU torch tensor (a copy)."""
    arr = np.array(a, copy=True)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.as_tensor(arr, dtype=dtype)


def n(x):
    """torch tensor or array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cuda_device():
    """The CUDA device for tests marked `cuda`; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


class Recorder:
    """Pass-through wrappers on module attributes that keep each call's
    (args, kwargs, result), by reference, in `calls[name]` while the
    context is open."""

    def __init__(self, module, *names):
        self.module = module
        self.orig = {name: getattr(module, name) for name in names}
        self.calls = {name: [] for name in names}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.module, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls[name].append((args, kwargs, out))
            return out
        return rec

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)


def assert_h_close(got, want):
    """Each 3x3 H within rtol 1e-4 in the max norm: |dH|max <= 1e-4
    |H|max, matrix by matrix (the eigh/inverse rounding of the IRLS refit,
    and the card's batched eigensolver, act on the whole matrix, so a
    small entry may carry more relative error than the matrix)."""
    got, want = n(got).astype(np.float64), n(want).astype(np.float64)
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-4 * scale), \
        float(np.abs(got - want).max())


def rel_rotation_deg(ra, rb) -> float:
    """Angle (degrees) of ra @ rb^T."""
    m = np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T
    # atan2 of the skew and symmetric parts: arccos((tr - 1) / 2) loses
    # ~0.04 degree near 0 to float32 rotations' 1e-7 scale error.
    sin = np.linalg.norm([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                          m[1, 0] - m[0, 1]]) / 2
    return float(np.degrees(np.arctan2(sin, (np.trace(m) - 1) / 2)))


@contextlib.contextmanager
def checked_keys(seed: int, n_pairs: int):
    """Watch the port's RANSAC draw its own numbers: `match_all_pairs`
    draws through `ops/ransac.py::ransac_draws`, and pair p must take
    split(PRNGKey(seed), n_pairs)[p], the reference stitch's key, bit for
    bit; no call of `ransac_homography`/`ransac_affine_partial` takes
    injected indices.  The calls pass through unchanged.  Yields a
    one-element list counting the pairs drawn."""
    import jax
    from image_stitching_tpu_torch.ops import matching as tmatching
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                       n_pairs)).astype(np.int64)
    real = {name: getattr(tmatching, name) for name in (
        "ransac_draws", "ransac_homography", "ransac_affine_partial")}
    done = [0]

    def draws(key, *args, **kwargs):
        rows = n(key)
        assert np.array_equal(rows, want[done[0]:done[0] + len(rows)]), \
            f"pairs {done[0]}.. did not take the reference's keys"
        done[0] += len(rows)
        return real["ransac_draws"](key, *args, **kwargs)

    def no_injection(fn):
        def call(*args, **kwargs):
            assert kwargs.get("hyp_idx") is None, "draws were injected"
            return fn(*args, **kwargs)
        return call
    for name, fn in real.items():
        setattr(tmatching, name,
                draws if name == "ransac_draws" else no_injection(fn))
    try:
        yield done
    finally:
        for name, fn in real.items():
            setattr(tmatching, name, fn)


def write_mixed_ring(directory, hws, fov_deg=55.0, overlap_ratio=0.6,
                     seed=7, noise_sigma=4.0):
    """A horizontal ring whose view i is rendered at its own size hws[i]
    with its own K (the same horizontal field of view), sigma-4 sensor
    noise drawn in view order from `seed`, stored rotated 180 degrees as
    JPEGs with each view's EXIF pose payload.  Returns ([K float64],
    [R float64])."""
    import os
    from image_stitching_tpu_torch.core import exif, image_io
    from image_stitching_tpu_torch.data.synth import (ring_geometry,
                                                      render_view)
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    ks, rs_out = [], []
    for i, hw in enumerate(hws):
        k, rs = ring_geometry(len(hws), hw, fov_deg, overlap_ratio)
        view = render_view(k, rs[i], hw, seed)
        img = np.clip(view + rng.normal(0.0, noise_sigma, view.shape).astype(
            np.float32), 0.0, 255.0)
        r32 = rs[i].astype(np.float32)
        payload = exif.camera_to_image_description(
            focal=float(k[1, 1]), ppx=float(k[0, 2]), ppy=float(k[1, 2]),
            R=r32, is_portrait=False)
        image_io.write_jpeg_with_description(
            os.path.join(directory, f"{i}.jpg"),
            image_io.rotate_180(img.astype(np.uint8)), payload, quality=92)
        ks.append(k)
        rs_out.append(r32.astype(np.float64))
    return ks, rs_out


# ---- the card's kernel gates ------------------------------------------------

def kernel_launches(fn) -> int:
    """Kernel launches of one fn() call: the kernel nodes of a CUDA graph
    captured from it, read back by cuGraphGetNodes and
    cuGraphNodeGetType."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kernels += kind.value == 0      # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def moment_scale(img, xy, radius=20):
    """Sum of |v * d| over each keypoint's disk: the magnitude float32
    summation error scales with (the moments themselves may cancel)."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = xs * xs + ys * ys <= radius * radius
    cx = np.round(xy[:, 0]).astype(int)
    cy = np.round(xy[:, 1]).astype(int)
    v = img[cy[:, None] + ys[disk][None], cx[:, None] + xs[disk][None]]
    return np.stack([(v * np.abs(xs[disk])).sum(1),
                     (v * np.abs(ys[disk])).sum(1)], -1)


def bits(words):
    """Descriptor words -> their bits, (..., 32) of 0/1."""
    w = np.asarray(words).astype(np.uint32)
    return (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1


def plain_coords(xy, angle, pat_xy, h, w):
    """orb_sample_plain's rounded, clipped endpoint coordinates."""
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px, py = pat_xy[0][None], pat_xy[1][None]
    gx = torch.clamp(torch.round(xy[:, 0:1] + (ca * px - sa * py)), 0, w - 1)
    gy = torch.clamp(torch.round(xy[:, 1:2] + (sa * px + ca * py)), 0, h - 1)
    return n(gx), n(gy)


def check_k1(raws, blurs, xy, lvl, pat, radius):
    """K1 in one wrapper call against its plain version: per level
    moments within 1e-5 of the disk's |v * d| magnitude, samples equal
    wherever both versions' rounded coordinates agree (by the card's cos
    and sin), <= 1e-4 of the descriptor bits flipped."""
    from image_stitching_tpu_torch.kernels.orb_sample import (
        orb_sample_levels, orb_sample_levels_plain)
    before = orb_sample_levels.launches
    got = orb_sample_levels(raws, blurs, xy, lvl, pat, radius,
                            with_samples=True)
    assert orb_sample_levels.launches == before + 1
    want = orb_sample_levels_plain(raws, blurs, xy, lvl, pat, radius,
                                   with_samples=True)
    for i, raw in enumerate(raws):
        sel = lvl == i
        (s_k, a_k, m_k, d_k), (s_p, a_p, m_p, d_p) = (
            [x[sel] for x in out] for out in (got, want))
        np.testing.assert_array_less(
            np.abs(n(m_k) - n(m_p)), 1e-5 * np.maximum(
                moment_scale(n(raw), n(xy[sel]), radius), 1.0))
        agree = np.all([a == b for a, b in zip(
            plain_coords(xy[sel], a_k, pat, *raw.shape),
            plain_coords(xy[sel], a_p, pat, *raw.shape))], axis=0)
        np.testing.assert_array_equal(n(s_k)[agree], n(s_p)[agree])
        assert int((bits(n(d_k)) != bits(n(d_p))).sum()) <= \
            1e-4 * d_k.numel() * 32


def check_k2(calls):
    """K2 within 1e-4 of its plain version on recorded (src, sx, sy)."""
    from image_stitching_tpu_torch.kernels import warp_gather
    assert calls
    for (src, sx, sy), _, _ in calls:
        err = float((warp_gather.warp_bilinear(src, sx, sy) -
                     warp_gather.warp_bilinear_plain(src, sx, sy)).abs().max())
        assert err <= 1e-4, err


def check_k4(args, rows=None):
    """K4 in one launch against its plain version (on `rows` of each
    pair's A image where given, the plain version a pair at a time): i1,
    d1, d2 equal, i2 equal where d2 < 2^30."""
    from image_stitching_tpu_torch.kernels import hamming
    before = hamming.hamming_two_nn_pairs.launches
    got = hamming.hamming_two_nn_pairs(*args)
    assert hamming.hamming_two_nn_pairs.launches == before + 1
    desc, valid, ii, jj = args
    if rows is None:
        want = hamming.hamming_two_nn_pairs_plain(*args)
    else:
        got = [[x[:, rows] for x in side] for side in got]
        want = [[torch.stack(x) for x in zip(*[
            hamming.hamming_two_nn_plain(desc[a, rows], desc[b], valid[b])
            for a, b in zip(ia.tolist(), ib.tolist())])]
            for ia, ib in ((ii, jj), (jj, ii))]
    for g, w in zip(got, want):
        for m in (0, 1, 3):
            assert torch.equal(g[m], w[m]), m
        real = w[3] < 2.0 ** 30
        assert torch.equal(g[2][real], w[2][real])


def check_k5(calls):
    """K5's recorded calls replayed into fresh accumulators, one set for
    the calls that shared one, by the kernel and by its plain version:
    accumulators within 2e-3, the finalized u8 panorama within 1, masks
    equal; at most 2 n_bands + 1 kernels a call (CUDA graph nodes)."""
    from image_stitching_tpu_torch.kernels import multiband
    from image_stitching_tpu_torch.pipeline.compose_fused import _finalize
    assert calls
    sets = {}
    for (warped, weight, offs, accs, nb), _, _ in calls:
        got, want = sets.setdefault(id(accs[0]), (
            [torch.zeros_like(a) for a in accs],
            [torch.zeros_like(a) for a in accs]))
        multiband.pyramid_accumulate(warped, weight, offs, got, nb)
        multiband.pyramid_accumulate_plain(warped, weight, offs, want, nb)
        scratch = [torch.zeros_like(a) for a in accs]
        assert kernel_launches(lambda: multiband.pyramid_accumulate(
            warped, weight, offs, scratch, nb)) <= 2 * nb + 1
    torch.cuda.synchronize()
    for got, want in sets.values():
        assert max(float((a - b).abs().max())
                   for a, b in zip(got, want)) <= 2e-3
        (pano_k, mask_k), (pano_p, mask_p) = (
            _finalize(acc, len(acc) - 1) for acc in (got, want))
        assert int((pano_k.int() - pano_p.int()).abs().max()) <= 1
        assert torch.equal(mask_k, mask_p)


def check_k6(gray, *level, **kwargs):
    """K6 on one (H, W) view and level (level, lh, lw) in one launch
    against its plain version: all four planes bit for bit."""
    from image_stitching_tpu_torch.kernels import orb_detect
    gray = gray.contiguous()
    before = orb_detect.orb_detect_maps.launches
    got = orb_detect.orb_detect_maps(gray, *level, **kwargs)
    assert orb_detect.orb_detect_maps.launches == before + 1
    want = orb_detect.orb_detect_maps_plain(gray, *level, **kwargs)
    for name, a, b in zip(("img", "blur", "harris", "rank"), got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            (level, name)


def plain_err2(h_all, src, dst, score_idx):
    """(P, n_hyp, m) squared errors of K7's plain version."""
    from image_stitching_tpu_torch.kernels.ransac_score import apply_h
    n_hyp = h_all.shape[1]
    src_s = torch.gather(src, 1, score_idx[..., None].expand(-1, -1, 2))
    dst_s = torch.gather(dst, 1, score_idx[..., None].expand(-1, -1, 2))
    proj = apply_h(h_all, src_s[:, None].expand(-1, n_hyp, -1, -1))
    return torch.sum((proj - dst_s[:, None]) ** 2, dim=-1)


def check_k7(calls):
    """K7 on recorded calls, their pairs as one, against its plain version
    16 pairs at a time: counts equal on >= 99.9% of the hypotheses, off by
    one at most, and only where a point's squared error lies within 1e-3
    of thresh^2 (relative)."""
    from image_stitching_tpu_torch.kernels import ransac_score
    assert calls
    args = [torch.cat([c[0][i] for c in calls]) for i in range(4)]
    thresh = calls[0][0][4]
    got = ransac_score.ransac_score_counts(*args, thresh)
    n_equal = n_unexplained = max_diff = 0
    for a in range(0, args[0].shape[0], 16):
        cut = [x[a:a + 16] for x in args]
        diff = got[a:a + 16] - ransac_score.ransac_score_counts_plain(
            *cut, thresh)
        near = (torch.abs(plain_err2(*cut) / (thresh * thresh) - 1.0)
                <= 1e-3).sum(-1)
        max_diff = max(max_diff, int(diff.abs().max()))
        n_equal += int((diff == 0).sum())
        n_unexplained += int(((diff != 0) & (near == 0)).sum())
    assert max_diff <= 1 and n_unexplained == 0, (max_diff, n_unexplained)
    assert n_equal >= 0.999 * got.numel(), n_equal
