"""Port parity: fused multiband compose from identical cameras and masks,
and kernel K5 (`pyramid_accumulate`), the per-image pyramid accumulate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import n, t
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
    with pytest.raises(NotImplementedError):
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


def test_fused_compose_refuses_feather(compose_inputs):
    c = compose_inputs
    with pytest.raises(NotImplementedError):
        tcf.fused_compose(t(c["imgs"]), c["ks"], c["rs"],
                          warps.make_warper("spherical", c["focal"]),
                          c["corners"], c["sizes"], c["seam_masks"],
                          c["seam_corners"], 0.5, None, BlenderType.FEATHER,
                          5.0)


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


def test_k5_plain_matches_accumulate_impl(compose_inputs, k5_scene):
    """K5's plain version, fed the reference's own (warped, weight) of each
    compose rect, against `_accumulate_impl`'s accumulators (which ran the
    same samples through its scan body) and against the Pallas kernel
    `pyramid_accumulate` run by the Pallas interpreter on the CPU.  All
    three sum the same taps in other orders: max |diff| <= 2e-3 on the
    0-255 scale (measured 1.2e-4)."""
    s = k5_scene
    g = s["g"]
    want, rects = _jax_accumulate(compose_inputs, s)
    shapes = [(4, g.canvas_h >> b, g.canvas_w >> b)
              for b in range(g.n_bands + 1)]
    got = [torch.zeros(sh) for sh in shapes]
    for warped, weight, off in rects:
        pyramid_accumulate(t(warped), t(weight), off, got, g.n_bands)
    accs_p, waccs_p = pallas_pyramid_accumulate(
        jnp.asarray(np.stack([r[0] for r in rects])),
        jnp.asarray(np.stack([r[1] for r in rects])),
        jnp.asarray(np.asarray([r[2] for r in rects], np.int32)),
        tuple(jnp.zeros((3,) + sh[1:]) for sh in shapes),
        tuple(jnp.zeros(sh[1:]) for sh in shapes), n_bands=g.n_bands,
        interpret=True)
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
    for warped, weight, off in tcf.compose_samples(
            t(c["imgs"]), c["ks"], c["rs"],
            warps.make_warper("spherical", c["focal"]), c["corners"],
            c["sizes"], c["seam_masks"], c["seam_corners"], 0.5, comp, g):
        pyramid_accumulate(warped, weight, off, got, g.n_bands)
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
    w, wt = torch.zeros((3, 8, 8)), torch.zeros((8, 8))
    pyramid_accumulate_plain(w + 1, wt + 1, (4, 4), accs, 1)
    assert float(accs[0][3].sum()) == 64.0
    with pytest.raises(ValueError, match="multiple"):
        pyramid_accumulate(torch.zeros((3, 6, 8)), torch.zeros((6, 8)),
                           (0, 0), accs, 2)
    with pytest.raises(ValueError, match="accumulators"):
        pyramid_accumulate(w, wt, (0, 0), accs[:1], 1)
    with pytest.raises(TypeError):
        pyramid_accumulate(w.double(), wt, (0, 0), accs, 1)
    with pytest.raises(ValueError, match="weight"):
        pyramid_accumulate(w, wt[:4], (0, 0), accs, 1)


@pytest.mark.cuda
def test_k5_kernel_matches_plain_on_cuda():
    from _torch_port import cuda_device
    dev = cuda_device()
    rng = np.random.default_rng(8)
    nb, ph, pw = 3, 96, 128
    warped = t(rng.uniform(0, 255, (3, ph, pw)).astype(np.float32)).to(dev)
    weight = t((rng.random((ph, pw)) > 0.3).astype(np.float32)).to(dev)
    shapes = [(4, 160 >> b, 200 >> b) for b in range(nb + 1)]
    got = [torch.zeros(sh, device=dev) for sh in shapes]
    want = [torch.zeros(sh, device=dev) for sh in shapes]
    before = pyramid_accumulate.launches
    for off in ((0, 0), (40, 24), (200, 160)):
        pyramid_accumulate(warped, weight, off, got, nb)
        pyramid_accumulate_plain(warped, weight, off, want, nb)
    torch.cuda.synchronize()
    assert pyramid_accumulate.launches == before + 3
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-3
