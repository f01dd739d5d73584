"""Port parity: rotations, components, bundle adjustment, wave correction."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from _torch_port import n, rel_rotation_deg, t
from image_stitching_tpu.config import WaveCorrectKind as JWave
from image_stitching_tpu.data.synth import make_ring_captures
from image_stitching_tpu.geometry import rotation as jrot
from image_stitching_tpu.geometry.camera import Cameras as JCameras
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops.features import Features as JFeatures
from image_stitching_tpu.ops.features.orb import orb_detect_and_describe
from image_stitching_tpu.ops.matching import match_all_pairs
from image_stitching_tpu_torch.config import WaveCorrectKind
from image_stitching_tpu_torch.estimation import bundle_adjust as tba
from image_stitching_tpu_torch.estimation import components, wave_correct
from image_stitching_tpu_torch.geometry import rotation
from image_stitching_tpu_torch.interop import cameras_from_numpy

# The reference's estimation package re-exports functions under its module
# names, so the modules are imported by path.
jba = importlib.import_module("image_stitching_tpu.estimation.bundle_adjust")
jcomp = importlib.import_module("image_stitching_tpu.estimation.components")
jwave = importlib.import_module("image_stitching_tpu.estimation.wave_correct")


def _rotations(seed, k=6):
    return Rotation.random(k, random_state=seed).as_matrix().astype(
        np.float32)


def test_rodrigues_round_trip_parity():
    rs = _rotations(0, 16)
    rs[0] = np.eye(3)
    rs[1] = Rotation.from_rotvec([np.pi - 1e-3, 0, 0]).as_matrix()
    want = np.asarray(jrot.matrix_to_rodrigues(jnp.asarray(rs)))
    got = n(rotation.matrix_to_rodrigues(t(rs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        n(rotation.rodrigues_to_matrix(t(want))),
        np.asarray(jrot.rodrigues_to_matrix(jnp.asarray(want))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_biggest_component_equal(seed):
    rng = np.random.default_rng(seed)
    conf = rng.random((9, 9)) * (rng.random((9, 9)) > 0.75) * 2.0
    conf = np.maximum(conf, conf.T)
    assert components.biggest_component(conf, 0.95) == \
        jcomp.biggest_component(conf, 0.95)
    ds = components.DisjointSets(4)
    ds.merge(0, 2)
    ds.merge(3, 2)
    assert ds.find(3) == ds.find(0) != ds.find(1)


@pytest.mark.parametrize("kind", ["horiz", "vert", "auto"])
def test_wave_correct_parity(kind):
    rs = _rotations(3, 7)
    want = np.asarray(jwave.wave_correct(jnp.asarray(rs), JWave(kind)))
    got = n(wave_correct.wave_correct(t(rs), WaveCorrectKind(kind)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def ba_inputs():
    """Reference features + matches of a 3-image ring and prior cameras
    perturbed away from the ground truth."""
    images, k, rs = make_ring_captures(n_images=3, hw=(160, 224),
                                       fov_deg=55, overlap_ratio=0.55)
    feats = [orb_detect_and_describe(jimg.rgb_to_gray(jnp.asarray(im)),
                                     n_features=400) for im in images]
    stack = JFeatures(*(jnp.stack([getattr(f, name) for f in feats])
                        for name in ("xy", "response", "angle", "octave",
                                     "size", "desc", "valid")))
    pm = jax.tree.map(np.asarray, match_all_pairs(
        stack, jax.random.PRNGKey(0), pair_cap=400))
    xy = np.asarray(stack.xy)
    noise = Rotation.from_rotvec(np.random.default_rng(5).normal(
        0, 0.02, (3, 3))).as_matrix()
    r0 = np.einsum("nij,njk->nik", noise, rs).astype(np.float32)
    cams = JCameras(focal=np.full(3, k[0, 0] * 1.02, np.float32),
                    aspect=np.ones(3, np.float32),
                    ppx=np.full(3, k[0, 2], np.float32),
                    ppy=np.full(3, k[1, 2], np.float32), R=r0,
                    t=np.zeros((3, 3), np.float32))
    return xy, pm, cams


@pytest.mark.parametrize("refine_mask,max_deg", [("_____", 0.01),
                                                ("x____", 0.05)])
def test_bundle_adjust_from_identical_inputs(ba_inputs, refine_mask,
                                             max_deg):
    """Same packed problem; focal rtol 1e-3, relative rotations within
    0.01 degrees for the default rotation-only refinement.  With the focal
    free as well, three images condition the focal/rotation trade-off
    weakly and float32 rounding steers LM to a neighbouring point
    (measured 0.023 degrees): 0.05 degrees there."""
    xy, pm, cams = ba_inputs
    ref_prob = jba.pack_correspondences(type("F", (), {"xy": xy}), pm, 0.95)
    prob = tba.pack_correspondences(xy, pm, 0.95)
    for name in ("cam_i", "cam_j", "p_i", "p_j", "w"):
        np.testing.assert_array_equal(getattr(prob, name),
                                      getattr(ref_prob, name))
    ref = jba.bundle_adjust(cams, ref_prob, refine_mask=refine_mask)
    got = tba.bundle_adjust(cameras_from_numpy(cams, device="cpu"), prob,
                            refine_mask=refine_mask).numpy()
    np.testing.assert_allclose(got["focal"], np.asarray(ref.focal),
                               rtol=1e-3)
    rr = np.asarray(ref.R)
    for a in range(3):
        for b in range(a + 1, 3):
            ang = rel_rotation_deg(got["R"][a] @ got["R"][b].T,
                                   rr[a] @ rr[b].T)
            assert ang <= max_deg, (a, b, ang)
    assert tba.bundle_adjust(cameras_from_numpy(cams, device="cpu"),
                             None).focal is not None


def test_matches_graph_dot_text_equal():
    """The DOT text of a match graph, port against reference: edges above
    the threshold with their labels, isolated images as nodes."""
    from image_stitching_tpu.estimation.graph import matches_graph_dot as jdot
    from image_stitching_tpu_torch.estimation.graph import matches_graph_dot
    rng = np.random.default_rng(2)
    n_img = 5
    conf = rng.uniform(0, 2, (n_img, n_img))
    conf = np.triu(conf, 1) + np.triu(conf, 1).T
    conf[4] = conf[:, 4] = 0.0
    inl = rng.integers(0, 300, (n_img, n_img))
    nm = inl + rng.integers(0, 100, (n_img, n_img))
    names = [f"/caps/{i}.jpg" for i in range(n_img)]
    got = matches_graph_dot(names, conf, inl, nm, 1.0)
    assert got == jdot(names, conf, inl, nm, 1.0)
    assert got.count(" -- ") == int((np.triu(conf, 1) > 1.0).sum()) > 0
    assert '"4.jpg";' in got
