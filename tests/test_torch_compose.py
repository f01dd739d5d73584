"""Port parity: fused multiband compose from identical cameras and masks."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import n, t
from image_stitching_tpu.config import BlenderType as JBlend
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.ops import warps as jwarps
from image_stitching_tpu.pipeline import compose_fused as jcf
from image_stitching_tpu_torch.config import BlenderType
from image_stitching_tpu_torch.ops import blend, seams, warps
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
    assert np.array_equal(seams.find_seams(masks, "no")[0], masks[0])
    with pytest.raises(NotImplementedError):
        seams.find_seams(masks, "dp_color")


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
        c["sizes"], c["seam_masks"], c["seam_corners"], 0.5,
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
                          c["seam_corners"], 0.5, BlenderType.FEATHER, 5.0)
