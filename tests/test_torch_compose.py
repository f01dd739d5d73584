"""Port parity: fused multiband compose from identical cameras and masks,
and kernel K5 (`pyramid_accumulate`), the pyramid accumulate of one bucket
of rects."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import kernel_launches, n, t
from image_stitching_tpu.config import BlenderType as JBlend
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.kernels.multiband_pallas import \
    pyramid_accumulate as pallas_pyramid_accumulate
from image_stitching_tpu.ops import warps as jwarps
from image_stitching_tpu.pipeline import compose_fused as jcf
from image_stitching_tpu_torch.config import BlenderType
from image_stitching_tpu_torch.config import ExposureCompensatorType as ECType
from image_stitching_tpu_torch.kernels.multiband import (
    pyramid_accumulate, pyramid_accumulate_plain)
from image_stitching_tpu_torch.ops import blend, seams, warps
from image_stitching_tpu_torch.ops.exposure import ExposureCompensator
from image_stitching_tpu_torch.pipeline import compose_fused as tcf


@pytest.fixture(scope="module")
def compose_inputs():
    """A 3-image ring at compose scale 1 with its ground-truth cameras and
    the seam-scale warp masks (seam scale 0.5) as seam masks."""
    images, k, rs = make_ring_captures(n_images=3, hw=(120, 168),
                                       fov_deg=55, overlap_ratio=0.5)
    imgs = np.stack(images).astype(np.uint8)
    ks = np.repeat(k[None], 3, 0).astype(np.float32)
    rs = np.asarray(rs, np.float32)
    focal = float(k[0, 0])
    warper = jwarps.make_warper("spherical", focal)
    rois = [warper.warp_roi((120, 168), ks[i], rs[i]) for i in range(3)]
    k_seam = ks.copy()
    k_seam[:, :2] *= 0.5
    sw = jwarps.make_warper("spherical", focal * 0.5)
    srois = [sw.warp_roi((60, 84), k_seam[i], rs[i]) for i in range(3)]
    small = imgs[:, ::2, ::2]
    _, masks = jcf._warp_stack(
        jnp.asarray(small), jnp.asarray(k_seam), jnp.asarray(rs),
        jnp.float32(sw.scale),
        jnp.asarray(np.asarray([r[:2] for r in srois], np.float32)),
        proj_name="spherical",
        pad_h=-(-max(r[3] for r in srois) // 64) * 64,
        pad_w=-(-max(r[2] for r in srois) // 64) * 64)
    masks = np.asarray(masks)
    seam_masks = [masks[i, :srois[i][3], :srois[i][2]] for i in range(3)]
    return dict(imgs=imgs, ks=ks, rs=rs, focal=focal,
                corners=[r[:2] for r in rois], sizes=[r[2:] for r in rois],
                seam_masks=seam_masks, seam_corners=[r[:2] for r in srois])


def test_num_bands_and_bucket_dims():
    from image_stitching_tpu.ops import blend as jblend
    from image_stitching_tpu.ops import seams as jseams
    for roi in ((0, 0, 3000, 500), (0, 0, 40, 30), (5, 5, 9, 9)):
        assert blend.num_bands_for(roi, 5.0) == jblend.num_bands_for(roi, 5.0)
    for x in (1, 16, 17, 25, 300, 306, 1000, 4097):
        assert seams.bucket_dim(x) == jseams.bucket_dim(x)
    masks = [np.full((4, 5), 255, np.uint8)]
    assert np.array_equal(seams.find_seams([(0, 0)], masks, "no")[0],
                          masks[0])
    with pytest.raises(ValueError, match="images_dev"):
        seams.find_seams([(0, 0)], masks, "gc_color")


def test_fused_compose_matches_reference(compose_inputs):
    """u8 panorama within +-1 on >= 99.9% of the mask's pixels (float32
    summation order in the pyramids), masks equal."""
    c = compose_inputs
    ref_pano, ref_mask = jcf.fused_compose(
        jnp.asarray(c["imgs"]), c["ks"], c["rs"],
        jwarps.make_warper("spherical", c["focal"]), c["corners"],
        c["sizes"], c["seam_masks"], c["seam_corners"], 0.5, None,
        JBlend.MULTI_BAND, 5.0)
    pano, mask = tcf.fused_compose(
        t(c["imgs"]), c["ks"], c["rs"],
        warps.make_warper("spherical", c["focal"]), c["corners"],
        c["sizes"], c["seam_masks"], c["seam_corners"], 0.5, None,
        BlenderType.MULTI_BAND, 5.0)
    ref_pano, ref_mask = np.asarray(ref_pano), np.asarray(ref_mask)
    assert n(pano).shape == ref_pano.shape
    np.testing.assert_array_equal(n(mask), ref_mask)
    close = np.all(np.abs(n(pano) - ref_pano) <= 1.0, -1)
    assert close[ref_mask].mean() >= 0.999
    assert ref_mask.mean() > 0.5


def _proj_scene(proj: str):
    """compose_inputs' ring with its ROIs and seam masks made by the
    projection `proj`."""
    images, k, rs = make_ring_captures(n_images=3, hw=(120, 168),
                                       fov_deg=55, overlap_ratio=0.5)
    imgs = np.stack(images).astype(np.uint8)
    ks = np.repeat(k[None], 3, 0).astype(np.float32)
    rs = np.asarray(rs, np.float32)
    focal = float(k[0, 0])
    warper = jwarps.make_warper(proj, focal)
    rois = [warper.warp_roi((120, 168), ks[i], rs[i]) for i in range(3)]
    k_seam = ks.copy()
    k_seam[:, :2] *= 0.5
    sw = jwarps.make_warper(proj, focal * 0.5)
    srois = [sw.warp_roi((60, 84), k_seam[i], rs[i]) for i in range(3)]
    _, masks = jcf._warp_stack(
        jnp.asarray(imgs[:, ::2, ::2]), jnp.asarray(k_seam), jnp.asarray(rs),
        jnp.float32(sw.scale),
        jnp.asarray(np.asarray([r[:2] for r in srois], np.float32)),
        proj_name=proj,
        pad_h=-(-max(r[3] for r in srois) // 64) * 64,
        pad_w=-(-max(r[2] for r in srois) // 64) * 64)
    masks = np.asarray(masks)
    return dict(imgs=imgs, ks=ks, rs=rs, focal=focal, proj=proj,
                corners=[r[:2] for r in rois], sizes=[r[2:] for r in rois],
                seam_masks=[masks[i, :srois[i][3], :srois[i][2]]
                            for i in range(3)],
                seam_corners=[r[:2] for r in srois])


# (projection, blend, blend strength): FEATHER and NO at 0 bands,
# cylindrical (separable maps) and mercator (a meshgrid map) multiband.
BLEND_CASES = {
    "feather": ("spherical", "feather", 5.0),
    "feather sharp": ("spherical", "feather", 1.0),
    "no": ("spherical", "no", 5.0),
    "cylindrical": ("cylindrical", "multiband", 5.0),
    "mercator": ("mercator", "multiband", 5.0),
}


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_fused_compose_blends_and_projections(case):
    """fused_compose against the reference's for FEATHER, NO and two more
    projections: masks equal, the u8 panorama within 1 on >= 99.9% of the
    mask (float32 ulps of the backward maps and the pyramid sums, the
    multiband parity test's bound) and within 1 everywhere at 0 bands."""
    proj, blend, strength = BLEND_CASES[case]
    c = _proj_scene(proj)
    ref_pano, ref_mask = jcf.fused_compose(
        jnp.asarray(c["imgs"]), c["ks"], c["rs"],
        jwarps.make_warper(proj, c["focal"]), c["corners"], c["sizes"],
        c["seam_masks"], c["seam_corners"], 0.5, None, JBlend(blend),
        strength)
    pano, mask = tcf.fused_compose(
        t(c["imgs"]), c["ks"], c["rs"], warps.make_warper(proj, c["focal"]),
        c["corners"], c["sizes"], c["seam_masks"], c["seam_corners"], 0.5,
        None, BlenderType(blend), strength)
    ref_pano, ref_mask = np.asarray(ref_pano), np.asarray(ref_mask)
    np.testing.assert_array_equal(n(mask), ref_mask)
    diff = np.abs(n(pano) - ref_pano).max(-1)
    assert (diff <= 1.0)[ref_mask].mean() >= 0.999
    g = tcf.compose_rects(c["corners"], c["sizes"], BlenderType(blend),
                          strength)
    if blend != "multiband":
        assert g.n_bands == 0 and diff[ref_mask].max() <= 1.0
    assert (g.feather_sharpness > 0) == (blend == "feather")
    assert ref_mask.mean() > 0.5


def test_l1_dist_exact():
    """The min-plus doubling L1 distance equals the reference's exactly,
    and both equal the brute-force city-block distance where it is below
    2^rounds - 1."""
    rng = np.random.default_rng(11)
    seed = rng.random((37, 53)) > 0.97
    for rounds in (1, 3, 6):
        got = n(tcf._l1_dist(t(seed), rounds))
        np.testing.assert_array_equal(
            got, np.asarray(jcf._l1_dist(jnp.asarray(seed), rounds)))
    ys, xs = np.nonzero(seed)
    yy, xx = np.mgrid[0:37, 0:53]
    brute = np.min(np.abs(yy[..., None] - ys) + np.abs(xx[..., None] - xs),
                   -1)
    np.testing.assert_array_equal(got[brute < 63], brute[brute < 63])


def test_k5_plain_zero_bands_matches_pallas_interpret():
    """K5's plain version at n_bands = 0 (FEATHER and NO: one band, no
    pyrDown) against the Pallas kernel in the interpreter, a bucket of
    overlapping rects at odd offsets: the same sums in image order."""
    warped, weight = _k5_bucket(21, 4, 0, 40, 56)
    offs = [(0, 0), (13, 5), (37, 22), (3, 29)]
    got = [torch.zeros((4, 70, 96))]
    pyramid_accumulate(warped, weight, offs, got, 0)
    accs_p, waccs_p = pallas_pyramid_accumulate(
        jnp.asarray(n(warped)), jnp.asarray(n(weight)),
        jnp.asarray(np.asarray(offs, np.int32)), (jnp.zeros((3, 70, 96)),),
        (jnp.zeros((70, 96)),), n_bands=0, interpret=True)
    pallas = np.concatenate([np.asarray(accs_p[0]),
                             np.asarray(waccs_p[0])[None]])
    np.testing.assert_allclose(n(got[0]), pallas, rtol=0, atol=1e-3)
    assert float(got[0][3].max()) >= 2   # the rects overlap


@pytest.fixture(scope="module")
def k5_scene(compose_inputs):
    """The fixture's ring composed at 2 bands (blend strength chosen for a
    blend width of 6 px) with GAIN_BLOCKS maps: per image a random map
    inside its own grid, zero-padded to the largest grid, and the JAX
    compose's seam masks.  Returns what both accumulates take."""
    c = compose_inputs
    canvas = warps.result_roi(c["corners"], c["sizes"])
    strength = 6.0 * 100.0 / np.sqrt(canvas[2] * canvas[3])
    g = tcf.compose_rects(c["corners"], c["sizes"], BlenderType.MULTI_BAND,
                          strength)
    assert g.n_bands == 2
    rng = np.random.default_rng(4)
    grids = np.array([[3, 4], [4, 5], [2, 3]], np.float32)
    gains = np.zeros((3, 4, 5), np.float32)
    for i, (gh, gw) in enumerate(grids.astype(int)):
        gains[i, :gh, :gw] = rng.uniform(0.7, 1.3, (gh, gw))
    rois = np.asarray([[x, y, w, h] for (x, y), (w, h) in
                       zip(c["corners"], c["sizes"])], np.float32)
    return dict(g=g, strength=strength, gains=gains, grids=grids, rois=rois,
                smask=jcf._prep_seam_masks(c["seam_masks"], 3)[0],
                canvas_tl=(canvas[0], canvas[1]))


def _jax_accumulate(c, s):
    """The reference's `_accumulate_impl` (gain_mode "blocks"), bucket by
    bucket, and each image's (warped, weight) from its own compose sample
    (`_warp_gain_seam` under jit, as the scan body runs it)."""
    g, (cx, cy) = s["g"], s["canvas_tl"]
    warper = jwarps.make_warper("spherical", c["focal"])
    imgs = jnp.asarray(c["imgs"], jnp.float32)
    tls = np.asarray(g.tls, np.float32)
    stl = np.asarray(c["seam_corners"], np.float32)
    sample = jax.jit(jcf._warp_gain_seam,
                     static_argnames=("proj_name", "gain_mode", "use_pallas"))
    accs = jcf._init_accs(g.canvas_h, g.canvas_w, g.n_bands)
    rects = []
    for (bh, bw), idxs in sorted(g.buckets.items()):
        sel = np.asarray(idxs)
        accs = jcf._accumulate_impl(
            accs, imgs, jnp.asarray(sel, jnp.int32), jnp.asarray(c["ks"][sel]),
            jnp.asarray(c["rs"][sel]), jnp.float32(warper.scale),
            jnp.asarray(tls[sel]), jnp.asarray(np.float32([cx, cy])),
            s["smask"], jnp.asarray(stl[sel]), jnp.float32(0.5),
            jnp.asarray(s["gains"]), jnp.asarray(s["grids"][sel]),
            jnp.asarray(s["rois"][sel]), proj_name="spherical", pad_h=bh,
            pad_w=bw, n_bands=g.n_bands, gain_mode="blocks")
        for i in idxs:
            us = tls[i, 0] + jnp.arange(bw, dtype=jnp.float32)
            vs = tls[i, 1] + jnp.arange(bh, dtype=jnp.float32)
            warped, weight = sample(
                imgs[i], jnp.asarray(c["ks"][i]), jnp.asarray(c["rs"][i]), us,
                vs, jnp.float32(warper.scale), s["smask"][i],
                jnp.asarray(stl[i]), jnp.float32(0.5),
                jnp.asarray(s["gains"][i]), jnp.asarray(s["grids"][i]),
                jnp.asarray(s["rois"][i]), proj_name="spherical",
                gain_mode="blocks")
            rects.append((np.asarray(warped), np.asarray(weight),
                          (g.tls[i][0] - cx, g.tls[i][1] - cy)))
    return [np.asarray(a) for a in accs], rects


def _buckets(rects):
    """(warped, weight, offset) rects grouped by shape, as the compose's
    buckets come: (warped (N, 3, ph, pw), weight (N, ph, pw), offs)."""
    for _, grp in itertools.groupby(rects, key=lambda r: r[1].shape):
        grp = list(grp)
        yield (np.stack([r[0] for r in grp]), np.stack([r[1] for r in grp]),
               [r[2] for r in grp])


def test_k5_plain_matches_accumulate_impl(compose_inputs, k5_scene):
    """K5's plain version, fed the reference's own (warped, weight) of each
    compose rect one call per bucket, against `_accumulate_impl`'s
    accumulators (which ran the same samples through its scan body) and
    against the Pallas kernel `pyramid_accumulate` run by the Pallas
    interpreter on the CPU on the same buckets.  All three sum the same
    taps in other orders: max |diff| <= 2e-3 on the 0-255 scale (measured
    1.2e-4)."""
    s = k5_scene
    g = s["g"]
    want, rects = _jax_accumulate(compose_inputs, s)
    shapes = [(4, g.canvas_h >> b, g.canvas_w >> b)
              for b in range(g.n_bands + 1)]
    got = [torch.zeros(sh) for sh in shapes]
    accs_p = tuple(jnp.zeros((3,) + sh[1:]) for sh in shapes)
    waccs_p = tuple(jnp.zeros(sh[1:]) for sh in shapes)
    buckets = list(_buckets(rects))
    assert len(buckets) == len(g.buckets)
    for warped, weight, offs in buckets:
        pyramid_accumulate(t(warped), t(weight), offs, got, g.n_bands)
        accs_p, waccs_p = pallas_pyramid_accumulate(
            jnp.asarray(warped), jnp.asarray(weight),
            jnp.asarray(np.asarray(offs, np.int32)), accs_p, waccs_p,
            n_bands=g.n_bands, interpret=True)
    for b in range(g.n_bands + 1):
        pallas = np.concatenate([np.asarray(accs_p[b]),
                                 np.asarray(waccs_p[b])[None]])
        np.testing.assert_allclose(n(got[b]), want[b], rtol=0, atol=2e-3)
        np.testing.assert_allclose(n(got[b]), pallas, rtol=0, atol=2e-3)
    assert want[0][3].sum() > 0.3 * want[0][3].size   # the rects landed


def test_k5_compose_with_block_gains_matches_reference(compose_inputs,
                                                       k5_scene):
    """The port's compose samples (own K2 sample, block gains) through K5,
    against `_accumulate_impl`, finalized: masks equal and the u8 panorama
    within +-1 on >= 99.9% of the mask (float32 ulps of the backward maps,
    the compose parity test's bound)."""
    c, s = compose_inputs, k5_scene
    g = s["g"]
    want, _ = _jax_accumulate(c, s)
    got = [torch.zeros((4, g.canvas_h >> b, g.canvas_w >> b))
           for b in range(g.n_bands + 1)]
    comp = ExposureCompensator(ECType.GAIN_BLOCKS, s["gains"],
                               s["grids"].astype(np.int32))
    for warped, weight, offs in tcf.compose_buckets(
            t(c["imgs"]), c["ks"], c["rs"],
            warps.make_warper("spherical", c["focal"]), c["corners"],
            c["sizes"], c["seam_masks"], c["seam_corners"], 0.5, comp, g):
        pyramid_accumulate(warped, weight, offs, got, g.n_bands)
    pano_t, mask_t = tcf._finalize(got, g.n_bands)
    pano_j, mask_j = jcf._finalize_impl([jnp.asarray(a) for a in want],
                                        n_bands=g.n_bands)
    mask_j = np.asarray(mask_j)
    np.testing.assert_array_equal(n(mask_t), mask_j)
    diff = np.abs(n(pano_t).astype(int) - np.asarray(pano_j).astype(int))
    assert (diff.max(-1) <= 1)[mask_j].mean() >= 0.999
    assert mask_j.mean() > 0.5


def test_k5_wrapper_checks_inputs():
    accs = [torch.zeros((4, 16, 16)), torch.zeros((4, 8, 8))]
    w, wt = torch.zeros((2, 3, 8, 8)), torch.zeros((2, 8, 8))
    offs = [(4, 4), (0, 8)]
    pyramid_accumulate_plain(w + 1, wt + 1, offs, accs, 1)
    assert float(accs[0][3].sum()) == 128.0
    with pytest.raises(ValueError, match="multiple"):
        pyramid_accumulate(torch.zeros((1, 3, 6, 8)), torch.zeros((1, 6, 8)),
                           [(0, 0)], accs, 2)
    with pytest.raises(ValueError, match="accumulators"):
        pyramid_accumulate(w, wt, offs, accs[:1], 1)
    with pytest.raises(TypeError):
        pyramid_accumulate(w.double(), wt, offs, accs, 1)
    with pytest.raises(ValueError, match="weight"):
        pyramid_accumulate(w, wt[:, :4], offs, accs, 1)
    with pytest.raises(ValueError, match="weight"):
        pyramid_accumulate(w, wt[:1], offs, accs, 1)
    with pytest.raises(ValueError, match="warped"):
        pyramid_accumulate(w[0], wt[0], offs[0], accs, 1)
    # offs must be (N, 2).
    for bad in ([(0, 0)], offs + [(0, 0)], [(0, 0, 0), (0, 0, 0)], []):
        with pytest.raises(ValueError, match="offs"):
            pyramid_accumulate(w, wt, bad, accs, 1)
    # N = 0 accumulates nothing.
    before = [a.clone() for a in accs]
    pyramid_accumulate(torch.zeros((0, 3, 8, 8)), torch.zeros((0, 8, 8)),
                       [], accs, 1)
    pyramid_accumulate(torch.zeros((0, 3, 8, 8)), torch.zeros((0, 8, 8)),
                       np.zeros((0, 2), np.int64), accs, 1)
    for a, b in zip(accs, before):
        assert torch.equal(a, b)


def _k5_bucket(seed, n_img, nb, ph, pw):
    rng = np.random.default_rng(seed)
    warped = t(rng.uniform(0, 255, (n_img, 3, ph, pw)).astype(np.float32))
    weight = t((rng.random((n_img, ph, pw)) > 0.3).astype(np.float32))
    return warped, weight


@pytest.mark.parametrize("nb, ph, pw, canvas, offs", [
    (3, 96, 128, (160, 200), [(0, 0), (40, 24), (200, 160), (13, 5)]),
    (2, 32, 64, (48, 300), [(236, 16), (0, 0), (100, 3), (7, 9), (0, 0)]),
])
def test_k5_batched_plain_equals_single_image_calls(nb, ph, pw, canvas,
                                                    offs):
    """One call over a bucket of overlapping rects (windows at both canvas
    edges, clamped and odd offsets, a repeated window) equals one call per
    image in index order, bit for bit: the bucket adds in image order."""
    warped, weight = _k5_bucket(len(offs) + nb, len(offs), nb, ph, pw)
    shapes = [(4, canvas[0] >> b, canvas[1] >> b) for b in range(nb + 1)]
    batched = [torch.zeros(sh) for sh in shapes]
    single = [torch.zeros(sh) for sh in shapes]
    pyramid_accumulate(warped, weight, offs, batched, nb)
    for i, off in enumerate(offs):
        pyramid_accumulate(warped[i:i + 1], weight[i:i + 1], [off], single,
                           nb)
    for a, b in zip(batched, single):
        assert torch.equal(a, b)
    assert float(batched[0][3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nb, ph, pw, canvas, offs", [
    (3, 96, 128, (160, 200), [(0, 0), (40, 24), (200, 160), (13, 5)]),
    # 0 bands (FEATHER, NO): one band launch, no pyrDown.
    (0, 40, 56, (70, 96), [(0, 0), (13, 5), (37, 22), (3, 29)]),
    # Past the 128 images of one band launch; the last three clamp onto
    # one window across that boundary.
    (1, 16, 32, (40, 2064),
     [(16 * i + i % 3, 5 * (i % 5)) for i in range(130)]),
])
def test_k5_kernel_matches_plain_on_cuda(nb, ph, pw, canvas, offs):
    """One batched call of overlapping rects (windows at both canvas
    edges, clamped and odd offsets; a bucket of 130) against the plain
    version: accumulators within 2e-3 (float32 summation order), the
    finalized u8 panorama within 1 and its mask equal; one count, at most
    2 n_bands + 1 kernels in a CUDA graph of the call."""
    from _torch_port import cuda_device
    dev = cuda_device()
    warped, weight = _k5_bucket(8, len(offs), nb, ph, pw)
    warped, weight = warped.to(dev), weight.to(dev)
    shapes = [(4, canvas[0] >> b, canvas[1] >> b) for b in range(nb + 1)]
    got = [torch.zeros(sh, device=dev) for sh in shapes]
    want = [torch.zeros(sh, device=dev) for sh in shapes]
    before = pyramid_accumulate.launches
    pyramid_accumulate(warped, weight, offs, got, nb)
    pyramid_accumulate_plain(warped, weight, offs, want, nb)
    torch.cuda.synchronize()
    assert pyramid_accumulate.launches == before + 1
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-3
    (pano_k, mask_k), (pano_p, mask_p) = (tcf._finalize(acc, nb)
                                          for acc in (got, want))
    assert int((pano_k.int() - pano_p.int()).abs().max()) <= 1
    assert torch.equal(mask_k, mask_p)
    scratch = [torch.zeros(sh, device=dev) for sh in shapes]
    assert kernel_launches(lambda: pyramid_accumulate(
        warped, weight, offs, scratch, nb)) <= 2 * nb + 1
