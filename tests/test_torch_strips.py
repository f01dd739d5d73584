"""Port parity of the strip-streamed compose
(`pipeline/compose_fused.py::fused_compose_strips`).

The cases and inputs are tests/test_compose_strips.py's (seeded numpy
scenes): multiband at strip_w 64 and 96, NO, FEATHER with random seams, a
u8 stack into an `out` buffer, the 2x4 tile grid with GAIN exposure, and
narrow tiles on a wide canvas.  Each is held against the port's
`fused_compose` under the JAX test's own tolerance (mask equal, mean
|diff| < 0.5 and p99 <= 2; FEATHER exact; the u8 stack mean < 1.0), and
against the JAX package's strips: the mask equal and, with the u8
rounding of both finalizers taken out, the panorama within 1e-3.  A
sample budget below one bucket sends K5 the bucket in chunks, which
changes nothing in the output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import test_compose_strips as jcase
from _torch_port import n
from image_stitching_tpu.config import BlenderType as JBlender
from image_stitching_tpu.config import ExposureCompensatorType as JEC
from image_stitching_tpu.core.transfer import pack_mask_bits
from image_stitching_tpu.ops import exposure as jexposure
from image_stitching_tpu.ops.blend import WEIGHT_EPS as J_EPS
from image_stitching_tpu.ops.pyr_mat import pyr_up_mm as j_pyr_up
from image_stitching_tpu.ops.warps import make_warper as j_make_warper
from image_stitching_tpu.pipeline import compose_fused as jcf
from image_stitching_tpu_torch.config import BlenderType
from image_stitching_tpu_torch.config import ExposureCompensatorType as EC
from image_stitching_tpu_torch.ops.blend import collapse
from image_stitching_tpu_torch.ops.exposure import ExposureCompensator
from image_stitching_tpu_torch.ops.warps import make_warper
from image_stitching_tpu_torch.pipeline import compose_fused as tcf


def _port(jargs):
    """The JAX case's arguments for the port: a CPU tensor stack, the
    port's warper, blender and compensator."""
    (imgs, ks, rs, warper, corners, sizes, masks, seam_corners, ratio, comp,
     blend, strength) = jargs
    if comp is not None:
        comp = ExposureCompensator(EC(comp.comp_type.value),
                                   np.asarray(comp.gains),
                                   np.asarray(comp.grid_sizes))
    return (torch.as_tensor(np.array(imgs)), ks, rs,
            make_warper(warper.proj_name, warper.scale), corners, sizes,
            masks, seam_corners, ratio, comp, BlenderType(blend.value),
            strength)


def _grid_args():
    """test_strips_grid_mosaic_geometry's 2x4 tile grid with GAIN."""
    rows, cols, h, w, focal = 2, 4, 40, 56, 180.0
    num = rows * cols
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    imgs = np.stack([
        np.clip(np.stack([50 + xx + 7 * i, 60 + yy, 80 + 0.2 * xx], -1)
                + rng.uniform(-2, 2, (h, w, 3)), 0, 255)
        for i in range(num)]).astype(np.float32)
    k = np.tile(np.array([[focal, 0, w / 2], [0, focal, h / 2],
                          [0, 0, 1]], np.float32), (num, 1, 1))
    ys, ps = (w / focal) * 0.75, (h / focal) * 0.75
    rs = np.stack([
        (R.from_euler("y", ys * (c - (cols - 1) / 2))
         * R.from_euler("x", ps * (r - (rows - 1) / 2))
         ).as_matrix().astype(np.float32)
        for r in range(rows) for c in range(cols)])
    warper = j_make_warper("spherical", focal)
    corners, sizes = jcase._rois(warper, num, h, w, k, rs)
    seam_masks = [np.full((sizes[i][1], sizes[i][0]), 255, np.uint8)
                  for i in range(num)]
    comp = jexposure.ExposureCompensator(
        comp_type=JEC.GAIN,
        gains=np.linspace(0.8, 1.2, num).astype(np.float32),
        grid_sizes=np.ones((num, 2), np.int32))
    return (jnp.asarray(imgs), k, rs, warper, corners, sizes, seam_masks,
            corners, 1.0, comp, JBlender.MULTI_BAND, 5.0)


# case: (the JAX case's arguments, strip_w).
CASES = {
    "multiband_64": (lambda: jcase._compose_args(), 64),
    "multiband_96": (lambda: jcase._compose_args(), 96),
    "no_64": (lambda: jcase._compose_args(blend=JBlender.NO), 64),
    "feather_exact": (lambda: jcase._compose_args(
        blend=JBlender.FEATHER, masks="random"), 64),
    "grid_gain": (_grid_args, 64),
    "narrow_tiles": (lambda: jcase._compose_args(
        n=9, h=40, w=48, focal=60.0, masks="random"), 96),
}


def _close(got, want, mask, exact=False):
    diff = np.abs(got.astype(np.float32) - want)[mask]
    if exact:
        assert float(diff.max()) == 0.0, float(diff.max())
        return
    assert float(np.mean(diff)) < 0.5, float(np.mean(diff))
    assert float(np.percentile(diff, 99)) <= 2.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_strips_match_port_fused_compose(case):
    make, strip_w = CASES[case]
    args = _port(make())
    pano1, m1 = tcf.fused_compose(*args)
    pano2, m2 = tcf.fused_compose_strips(*args, strip_w=strip_w)
    assert isinstance(pano2, np.ndarray) and pano2.dtype == np.float32
    assert pano2.shape == tuple(pano1.shape)
    assert np.array_equal(n(m1), m2)
    _close(pano2, n(pano1), n(m1), exact=case == "feather_exact")


def _unrounded_finalizers(monkeypatch):
    """Both packages' strip finalizers without the u8 rounding: the
    collapsed float panorama, so the strips compare to float32 rounding."""
    def j_strip(accs, *, n_bands, margin, strip_w):
        bands = [accs[b][:3] / (accs[b][3:4] + J_EPS)
                 for b in range(n_bands + 1)]
        out = bands[-1]
        for b in range(n_bands - 1, -1, -1):
            out = j_pyr_up(out, bands[b].shape[1:]) + bands[b]
        out = jnp.transpose(out, (1, 2, 0))[:, margin:margin + strip_w]
        return out, pack_mask_bits(
            (accs[0][3] > J_EPS)[:, margin:margin + strip_w])

    def t_strip(accs, n_bands):
        out, mask = collapse(accs, n_bands)
        return out.permute(1, 2, 0), mask
    monkeypatch.setattr(jcf, "_finalize_strip_impl", j_strip)
    monkeypatch.setattr(tcf, "_finalize", t_strip)


@pytest.mark.parametrize("case", sorted(CASES))
def test_strips_match_reference_strips(case, monkeypatch):
    """The mask equal to the JAX strips'; the unrounded panorama within
    1e-3 (the same rects, cuts and margins in both)."""
    make, strip_w = CASES[case]
    jargs = make()
    _, mask_u8 = jcf.fused_compose_strips(*jargs, strip_w=strip_w)
    _, got_mask = tcf.fused_compose_strips(*_port(jargs), strip_w=strip_w)
    assert np.array_equal(got_mask, mask_u8)
    _unrounded_finalizers(monkeypatch)
    want, _ = jcf.fused_compose_strips(*jargs, strip_w=strip_w)
    got, _ = tcf.fused_compose_strips(*_port(jargs), strip_w=strip_w)
    np.testing.assert_allclose(got[got_mask], want[got_mask], rtol=0,
                               atol=1e-3)


def test_strips_uint8_stack_into_out_buffer():
    """A u8 stack composes as it is into a caller's u8 buffer: the mask
    equals fused_compose's on the float stack, mean |diff| < 1.0, and the
    JAX strips' u8 panorama within 1."""
    jargs = list(jcase._compose_args(n=5, masks="random"))
    pano1, m1 = tcf.fused_compose(*_port(jargs))
    jargs[0] = jnp.asarray(np.round(np.asarray(jargs[0])).astype(np.uint8))
    args = _port(jargs)
    assert args[0].dtype == torch.uint8
    out = np.zeros((pano1.shape[0], pano1.shape[1], 3), np.uint8)
    pano2, m2 = tcf.fused_compose_strips(*args, strip_w=64, out=out,
                                         out_dtype=np.uint8)
    assert pano2 is out
    assert np.array_equal(n(m1), m2)
    diff = np.abs(out.astype(np.float32) - n(pano1))[n(m1)]
    assert float(np.mean(diff)) < 1.0, float(np.mean(diff))
    want, want_mask = jcf.fused_compose_strips(*jargs, strip_w=64,
                                               out_dtype=np.uint8)
    assert np.array_equal(want_mask, m2)
    assert int(np.abs(out.astype(np.int32) - want)[m2].max()) <= 1


@pytest.mark.parametrize("case", ["multiband_64", "grid_gain"])
def test_chunked_buckets_equal_unchunked(case, monkeypatch):
    """A sample budget of one rect sends every bucket to K5 one rect a
    call: the strips and fused_compose are bit-equal to their unchunked
    calls."""
    make, strip_w = CASES[case]
    args = _port(make())
    whole = tcf.fused_compose_strips(*args, strip_w=strip_w)
    fused = tcf.fused_compose(*args)
    calls = []
    k5 = tcf.pyramid_accumulate

    def counting(warped, *rest):
        calls.append(warped.shape[0])
        return k5(warped, *rest)
    monkeypatch.setattr(tcf, "pyramid_accumulate", counting)
    monkeypatch.setattr(tcf, "SAMPLE_BUDGET", 1)
    chunked = tcf.fused_compose_strips(*args, strip_w=strip_w)
    assert set(calls) == {1}
    _, _, strips = tcf.strip_rects(args[4], args[5], args[10], args[11],
                                   strip_w)
    assert len(calls) == sum(len(g.tls) for g in strips)
    assert len(calls) > sum(len(g.buckets) for g in strips)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)
    fused_chunked = tcf.fused_compose(*args)
    for a, b in zip(fused, fused_chunked):
        np.testing.assert_array_equal(n(a), n(b))


def test_strip_geometry():
    """The strips' host geometry on the grid: strip_w rounded to the band
    step, a band-aligned margin, every image's cut rect inside its strip's
    frame, and each image in the strips its rect reaches."""
    args = _port(_grid_args())
    corners, sizes = args[4], args[5]
    g0 = tcf.compose_rects(corners, sizes, BlenderType.MULTI_BAND, 5.0)
    strip_w, margin, strips = tcf.strip_rects(
        corners, sizes, BlenderType.MULTI_BAND, 5.0, 50)
    band = 1 << g0.n_bands
    step = 1 << max(g0.n_bands, 1)
    assert strip_w % step == 0 and strip_w >= 50
    assert margin % band == 0 and margin >= 3 * band
    assert len(strips) == -(-g0.canvas[2] // strip_w)
    for s, g in enumerate(strips):
        x0 = g0.canvas[0] + s * strip_w - margin
        assert g.canvas == (x0, g0.canvas[1], strip_w + 2 * margin,
                            g0.canvas_h)
        assert g.canvas_h == g0.canvas_h and g.n_bands == g0.n_bands
        for (ph, pw), idxs in g.buckets.items():
            assert ph % band == 0 and pw % band == 0
            for i in idxs:
                tlx, tly = g.tls[i]
                assert tlx + pw <= x0 + g.canvas_w
                assert tly + ph <= g0.canvas[1] + g.canvas_h
    seen = sorted({i for g in strips for i in g.tls})
    assert seen == list(range(len(corners)))
