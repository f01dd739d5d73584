"""Port parity: camera seeding and the registration variants.

The capture rig, the rig captures, orthonormalize and the Euler
extraction, the homography/affine estimators, the affine RANSAC and
matcher (with the reference's keys), the ray/affine/no bundle
adjustment costs and the pose infill, each on the same seeded inputs
through the JAX package and the port."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from _torch_port import checked_keys, n, rel_rotation_deg, t
from image_stitching_tpu.core import rig as jrig
from image_stitching_tpu.data import synth as jsynth
from image_stitching_tpu.geometry import euler as jeuler
from image_stitching_tpu.geometry import rotation as jrot
from image_stitching_tpu.geometry.camera import Cameras as JCameras
from image_stitching_tpu.geometry.euler_order import EulerOrder
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops import matching as jm
from image_stitching_tpu.ops import ransac as jr
from image_stitching_tpu.ops.features import Features as JFeatures
from image_stitching_tpu.ops.features.orb import orb_detect_and_describe
from image_stitching_tpu_torch.core import rig
from image_stitching_tpu_torch.core.prng import PRNGKey
from image_stitching_tpu_torch.data import synth
from image_stitching_tpu_torch.estimation import bundle_adjust as tba
from image_stitching_tpu_torch.estimation import homography_estimator as the
from image_stitching_tpu_torch.estimation import pose_infill
from image_stitching_tpu_torch.geometry import euler, rotation
from image_stitching_tpu_torch.interop import (cameras_from_numpy,
                                               features_from_numpy)
from image_stitching_tpu_torch.ops import matching, ransac
from image_stitching_tpu_torch.ops.features import Features

# The reference's estimation package re-exports functions under its module
# names, so the modules are imported by path.
jba = importlib.import_module("image_stitching_tpu.estimation.bundle_adjust")
jhe = importlib.import_module(
    "image_stitching_tpu.estimation.homography_estimator")
jinfill = importlib.import_module(
    "image_stitching_tpu.estimation.pose_infill")

RING_HW = (160, 224)
CAM_FIELDS = ("focal", "aspect", "ppx", "ppy", "R", "t")


def _jfields(cams):
    return {name: np.asarray(getattr(cams, name)) for name in CAM_FIELDS}


def test_rig_api_equal_on_every_index():
    """total_images, group_of, group_index, group_start_end,
    rotation_prior and field_rect equal on all 37 indices; past the rig
    both raise IndexError."""
    jr_, tr = jrig.DEFAULT_RIG, rig.DEFAULT_RIG
    assert tr.total_images == jr_.total_images == 37
    assert tr.rings == tuple(rig.CaptureModeDesc(*(getattr(d, f) for f in (
        "x", "total_img", "error", "z_error", "angles", "start_y")))
        for d in jr_.rings)
    for i in range(37):
        g = tr.group_of(i)
        assert g == jr_.group_of(i)
        assert tr.group_index(i, g) == jr_.group_index(i, g)
        assert tr.group_start_end(g) == jr_.group_start_end(g)
        assert tr.rotation_prior(i) == jr_.rotation_prior(i)
        assert tr.field_rect(1.2, 0.9, i) == jr_.field_rect(1.2, 0.9, i)
    for r in (tr, jr_):
        with pytest.raises(IndexError):
            r.group_of(37)


def test_rig_captures_render_the_reference_scene():
    """make_rig_captures at 48x64: K equal, rotations within 1e-6, every
    image within 1 LSB of the reference's."""
    ref, k_ref, rs_ref = jsynth.make_rig_captures(hw=(48, 64))
    got, k, rs = synth.make_rig_captures(hw=(48, 64))
    assert len(got) == len(ref) == 37
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_allclose(rs, rs_ref, rtol=0, atol=1e-6)
    for a, b in zip(got, ref):
        assert np.abs(a - b).max() <= 1.0


def _rotations(seed, k=12):
    rs = Rotation.random(k, random_state=seed).as_matrix()
    # Gimbal lock of every order: a middle angle of +-90 degrees.
    lock = [Rotation.from_euler(o.lower(), [0.3, s * np.pi / 2, -0.2])
            .as_matrix() for o in ("XYZ", "ZYX", "YXZ") for s in (1, -1)]
    return np.concatenate([rs, np.stack(lock)]).astype(np.float32)


@pytest.mark.parametrize("order", euler.ORDERS)
def test_rotation_matrix_to_euler_parity(order):
    """All six orders, gimbal-locked matrices included: within 1e-5; the
    angles rebuild the matrix within 1e-5 in both packages."""
    rs = _rotations(1)
    want = np.asarray(jeuler.rotation_matrix_to_euler(jnp.asarray(rs),
                                                      EulerOrder(order)))
    got = euler.rotation_matrix_to_euler(rs, order)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.dtype == np.float32
    back = euler.euler_to_rotation_matrix(got, EulerOrder(order))
    np.testing.assert_allclose(back, np.asarray(
        jeuler.euler_to_rotation_matrix(jnp.asarray(want),
                                        EulerOrder(order))),
        rtol=0, atol=1e-5)


def test_orthonormalize_parity():
    """Perturbed rotations and a reflection: within 1e-5, det +1."""
    rng = np.random.default_rng(2)
    m = _rotations(3) + rng.normal(0, 0.05, (18, 3, 3)).astype(np.float32)
    m[0] = np.diag([1.0, 1.0, -1.0]) @ m[0]
    want = np.asarray(jrot.orthonormalize(jnp.asarray(m)))
    got = n(rotation.orthonormalize(t(m)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def _ring_h_grid(n_img, pitch):
    """(n, n, 3, 3) ground-truth K R_j^T R_i K^-1 of a 480x640 ring, in
    pixel coordinates."""
    k, rs = synth.ring_geometry(n_img, (480, 640), 55.0, 0.5, pitch)
    return np.stack([np.stack([k @ rs[j].T @ rs[i] @ np.linalg.inv(k)
                               for j in range(n_img)])
                     for i in range(n_img)])


def _ring_homographies():
    """The off-diagonal pairs of a ring and of a pitched ring."""
    off = ~np.eye(4, dtype=bool)
    return np.concatenate([_ring_h_grid(4, pitch)[off]
                           for pitch in (0.0, 20.0)])


def _random_homographies(seed, k=200):
    rng = np.random.default_rng(seed)
    h = np.eye(3) + rng.normal(0, 0.3, (k, 3, 3)) * np.array(
        [[1, 1, 300], [1, 1, 300], [1e-3, 1e-3, 0]])
    h[:5, 2, :2] = 0.0                     # affine: d1 = d2 = 0 branches
    return h


@pytest.mark.parametrize("which", ["ring", "random"])
def test_focals_from_homography_parity(which):
    """Both estimates, None where underdetermined, within 1e-9 (f64)."""
    hs = (_ring_homographies() if which == "ring"
          else _random_homographies(4))
    n_some = 0
    for h in hs:
        want = jhe.focals_from_homography(h)
        got = the.focals_from_homography(h)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                n_some += 1
                assert abs(g - w) <= 1e-9 * abs(w)
    assert n_some > len(hs) // 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_focal_parity(seed):
    """The median over confident ordered pairs, and the (w + h) / 2
    fallback when too few pairs are confident: within 1e-9 (f64)."""
    rng = np.random.default_rng(seed)
    n_img = 5
    hs = _ring_h_grid(n_img, 10.0)
    hs = hs + rng.normal(0, 1e-4, hs.shape) * np.abs(hs)
    sizes = [(480, 640)] * n_img
    for frac in (0.7, 0.05):
        conf = rng.random((n_img, n_img)) * 2.0 * (rng.random(
            (n_img, n_img)) < frac)
        want = jhe.estimate_focal(hs, conf, sizes, 0.5)
        got = the.estimate_focal(hs, conf, sizes, 0.5)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        assert got.dtype == np.float64


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_max_spanning_tree_edges_equal(seed):
    """Integer weights with many ties (the first edge found wins), 37
    nodes as the rig has: the same edges in the same order."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 4, (37, 37)) * (rng.random((37, 37)) < 0.4)
    w = np.maximum(w, w.T)
    assert the.max_spanning_tree(w) == jhe._max_spanning_tree(w)


@pytest.fixture(scope="module")
def ring_features():
    """The reference's ORB features of a 3-image ring (160x224), stacked
    for both packages."""
    images, k, rs = jsynth.make_ring_captures(
        n_images=3, hw=RING_HW, fov_deg=55, overlap_ratio=0.55)
    feats = [orb_detect_and_describe(jimg.rgb_to_gray(jnp.asarray(im)),
                                     n_features=400) for im in images]
    stack = JFeatures(*(jnp.stack([getattr(f, name) for f in feats])
                        for name in ("xy", "response", "angle", "octave",
                                     "size", "desc", "valid")))
    tstack = Features.stack([
        features_from_numpy(jax.tree.map(np.asarray, f), device="cpu")
        for f in feats])
    return stack, k, rs, tstack


@pytest.fixture(scope="module")
def graphs(ring_features):
    """The reference's match graphs of the ring, homography and affine
    matcher, with numpy leaves; and the port's affine graph on the same
    features with the same key."""
    stack, _, _, tstack = ring_features
    key = jax.random.PRNGKey(0)
    ref = {mt: jax.tree.map(np.asarray, jm.match_all_pairs(
        stack, key, matcher_type=mt, pair_cap=400))
        for mt in ("homography", "affine")}
    with checked_keys(0, 3) as drawn:
        got = matching.match_all_pairs(tstack, PRNGKey(0, "cpu"),
                                       pair_cap=400,
                                       matcher_type="affine").numpy()
    assert drawn[0] == 3
    return ref, got


def test_ransac_affine_injected_hypotheses():
    """A similarity with 20% outliers: inlier masks bit-equal, counts
    equal, H within 1e-4 of its largest entry."""
    rng = np.random.default_rng(5)
    m = 300
    src = rng.uniform(0, 400, (m, 2)).astype(np.float32)
    ang, s = 0.08, 1.03
    h_true = np.array([[s * np.cos(ang), -s * np.sin(ang), 25.0],
                       [s * np.sin(ang), s * np.cos(ang), -9.0], [0, 0, 1]])
    dst = (np.c_[src, np.ones(m)] @ h_true.T)[:, :2].astype(np.float32)
    dst += rng.normal(0, 0.5, dst.shape).astype(np.float32)
    dst[:60] = rng.uniform(0, 400, (60, 2))
    valid = rng.random(m) > 0.05
    key = jax.random.PRNGKey(3)
    h_ref, mask_ref, n_ref = jr.ransac_affine_partial(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key)
    hyp = jr._sample_valid_distinct(key, jnp.asarray(valid), 512, 2)
    h, mask, cnt = ransac.ransac_affine_partial(
        t(src)[None], t(dst)[None], t(valid)[None],
        hyp_idx=t(np.asarray(hyp))[None].long())
    assert int(cnt[0]) == int(n_ref) > 200
    np.testing.assert_array_equal(n(mask[0]), np.asarray(mask_ref))
    h_ref = np.asarray(h_ref)
    assert np.abs(n(h[0]) - h_ref).max() <= 1e-4 * np.abs(h_ref).max()


def test_affine_matcher_inlier_counts_equal(graphs):
    """match_all_pairs(matcher_type="affine") on the same features with
    the same key: ratio-test tables, inlier masks and counts
    equal; confidences within 1e-6, H within 1e-4 of its largest entry."""
    ref, got = graphs
    ref = ref["affine"]
    for name in ("ii", "jj", "a_idx", "b_idx", "valid", "inlier",
                 "num_inliers", "num_matches"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    assert (ref.num_inliers[0, 1], ref.num_inliers[1, 2]) > (8, 8)
    np.testing.assert_allclose(got.confidence, ref.confidence, rtol=1e-6)
    scale = np.abs(ref.h).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got.h - ref.h) <= 1e-4 * scale)


SIZES = [RING_HW] * 3


@pytest.mark.parametrize("estimator", ["homography", "affine"])
def test_estimators_on_the_reference_graph(graphs, estimator):
    """homography_based_estimate / affine_based_estimate on the
    reference's MatchGraph of the ring: every camera field within 1e-5
    (relative to the field's largest entry)."""
    ref, _ = graphs
    pm = ref[estimator]
    fn = f"{estimator}_based_estimate"
    want = _jfields(getattr(jhe, fn)(pm, SIZES, 0.5))
    got = getattr(the, fn)(pm, SIZES, 0.5)
    assert set(got) == set(CAM_FIELDS)
    for name in CAM_FIELDS:
        assert got[name].dtype == np.float32, name
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(
                                       want[name]).max()), err_msg=name)


@pytest.fixture(scope="module")
def ba_inputs(ring_features, graphs):
    """The packed problem of the ring's homography graph and prior cameras
    perturbed away from the ground truth."""
    stack, k, rs, _ = ring_features
    ref, _ = graphs
    xy = np.asarray(stack.xy)
    noise = Rotation.from_rotvec(np.random.default_rng(5).normal(
        0, 0.02, (3, 3))).as_matrix()
    r0 = np.einsum("nij,njk->nik", noise, rs).astype(np.float32)
    cams = JCameras(focal=np.full(3, k[0, 0] * 1.02, np.float32),
                    aspect=np.ones(3, np.float32),
                    ppx=np.full(3, k[0, 2], np.float32),
                    ppy=np.full(3, k[1, 2], np.float32), R=r0,
                    t=np.zeros((3, 3), np.float32))
    return xy, ref, cams


@pytest.mark.parametrize("refine_mask,max_deg", [("_____", 0.01),
                                                ("x____", 0.05)])
def test_bundle_adjust_ray_parity(ba_inputs, refine_mask, max_deg):
    """The ray cost from the same problem and seed, under the reproj BA's
    tolerances (tests/test_torch_estimation.py): focal rtol 1e-3,
    relative rotations within 0.01 degrees, 0.05 with the focal free."""
    xy, ref, cams = ba_inputs
    pm = ref["homography"]
    prob = tba.pack_correspondences(xy, pm, 0.95)
    want = jba.bundle_adjust(cams, jba.pack_correspondences(
        type("F", (), {"xy": xy}), pm, 0.95), cost_func="ray",
        refine_mask=refine_mask)
    got = tba.bundle_adjust(cameras_from_numpy(cams, device="cpu"), prob,
                            cost_func="ray",
                            refine_mask=refine_mask).numpy()
    np.testing.assert_allclose(got["focal"], np.asarray(want.focal),
                               rtol=1e-3)
    rr = np.asarray(want.R)
    moved = 0.0
    for a in range(3):
        moved = max(moved, rel_rotation_deg(rr[a], cams.R[a]))
        for b in range(a + 1, 3):
            ang = rel_rotation_deg(got["R"][a] @ got["R"][b].T,
                                   rr[a] @ rr[b].T)
            assert ang <= max_deg, (a, b, ang)
    assert moved > 0.1      # the LM did move the seed


def test_bundle_adjust_affine_parity(ring_features, graphs):
    """The affine cost from the reference's affine seed and packed
    problem: each similarity's rotation within 0.01 degrees, scale within
    rtol 1e-3 and translation within 1e-3 of the image width, the
    reproj BA's tolerances carried over; camera 0 stays fixed."""
    stack = ring_features[0]
    ref, _ = graphs
    pm = ref["affine"]
    xy = np.asarray(stack.xy)
    seed = jhe.affine_based_estimate(pm, SIZES, 0.5)
    want = np.asarray(jba.bundle_adjust(seed, jba.pack_correspondences(
        type("F", (), {"xy": xy}), pm, 0.5), cost_func="affine").R)
    got = n(tba.bundle_adjust(cameras_from_numpy(seed, device="cpu"),
                              tba.pack_correspondences(xy, pm, 0.5),
                              cost_func="affine").R)
    np.testing.assert_array_equal(got[0], np.eye(3, dtype=np.float32))
    assert np.abs(want - np.asarray(seed.R)).max() > 1e-3
    for g, w in zip(got, want):
        ang = np.degrees(np.arctan2(g[1, 0], g[0, 0]) -
                         np.arctan2(w[1, 0], w[0, 0]))
        assert abs(ang) <= 0.01
        np.testing.assert_allclose(np.hypot(g[0, 0], g[1, 0]),
                                   np.hypot(w[0, 0], w[1, 0]), rtol=1e-3)
        np.testing.assert_allclose(g[:2, 2], w[:2, 2], rtol=0,
                                   atol=1e-3 * RING_HW[1])
        np.testing.assert_array_equal(g[2], [0, 0, 1])


def test_bundle_adjust_no_and_empty(ba_inputs):
    """cost_func="no" and an empty problem return the seed unchanged, as
    the reference does; an unknown cost raises ValueError in both."""
    xy, ref, cams = ba_inputs
    prob = tba.pack_correspondences(xy, ref["homography"], 0.95)
    seed = cameras_from_numpy(cams, device="cpu")
    for cost in ("no", "reproj", "ray", "affine"):
        out = tba.bundle_adjust(seed, prob if cost == "no" else None,
                                cost_func=cost)
        assert out is seed
        assert jba.bundle_adjust(cams, None, cost_func=cost) is cams
    with pytest.raises(ValueError, match="cost function"):
        tba.bundle_adjust(seed, prob, cost_func="nope")
    with pytest.raises(ValueError, match="cost function"):
        jba.bundle_adjust(cams, jba.pack_correspondences(
            type("F", (), {"xy": xy}), ref["homography"], 0.95),
            cost_func="nope")


def _infill_case(n_img, kept, seed):
    """Prior cameras of a rig (37) or a ring (< 37) and refined cameras
    of the kept ones: the priors turned by a small global rotation plus
    noise, other focals and principal points."""
    rng = np.random.default_rng(seed)
    if n_img == 37:
        _, k, rs = jsynth.make_rig_captures(hw=(2, 2))
        rs = np.asarray(rs)
    else:
        rs = np.stack([Rotation.from_euler("y", 0.3 * i).as_matrix()
                       for i in range(n_img)]).astype(np.float32)
    priors = JCameras(
        focal=rng.uniform(490, 510, n_img).astype(np.float32),
        aspect=np.ones(n_img, np.float32),
        ppx=np.full(n_img, 320.0, np.float32),
        ppy=np.full(n_img, 240.0, np.float32), R=rs.astype(np.float32),
        t=rng.normal(0, 1, (n_img, 3)).astype(np.float32))
    g = Rotation.from_euler("zx", [0.05, -0.03]).as_matrix()
    jit = Rotation.from_rotvec(rng.normal(0, 0.01, (len(kept), 3)))
    refined = JCameras(
        focal=rng.uniform(500, 520, len(kept)).astype(np.float32),
        aspect=np.ones(len(kept), np.float32),
        ppx=rng.uniform(315, 325, len(kept)).astype(np.float32),
        ppy=rng.uniform(235, 245, len(kept)).astype(np.float32),
        R=np.stack([jit[a].as_matrix() @ g @ rs[i]
                    for a, i in enumerate(kept)]).astype(np.float32),
        t=np.zeros((len(kept), 3), np.float32))
    return priors, refined


# 37 images: drops within rings, a whole pole ring (indices 33-36, so
# the ring search finds nothing and the global one runs) and the first
# and last index; 6 images without a rig.
INFILL = {
    "rig": (37, [i for i in range(37)
                 if i not in (0, 5, 6, 15, 20, 30, 33, 34, 35, 36)]),
    "no rig": (6, [0, 1, 2, 4]),
}


@pytest.mark.parametrize("case", sorted(INFILL))
def test_pose_infill_parity(case):
    """infill_dropped_cameras, DEFAULT_RIG at n = 37 and rig=None: every
    field within 1e-5."""
    n_img, kept = INFILL[case]
    priors, refined = _infill_case(n_img, kept, 3)
    use_rig = case == "rig"
    want = _jfields(jinfill.infill_dropped_cameras(
        priors, refined, kept, jrig.DEFAULT_RIG if use_rig else None))
    got = pose_infill.infill_dropped_cameras(
        _jfields(priors), _jfields(refined), kept,
        rig.DEFAULT_RIG if use_rig else None)
    for name in CAM_FIELDS:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-5, err_msg=name)
    dropped = [i for i in range(n_img) if i not in kept]
    assert np.abs(got["R"][dropped] - priors.R[dropped]).max() > 1e-3


def test_affine_warp_maps_are_the_cameras():
    """The affine warp: for a linear part that is a rotation the map is
    the reference's split (`Warper.warp_backward_coords`, within rtol 1e-5
    / atol 1e-3 px); for similarities of scale 0.97 and 1.03 the ROI's
    forward map (`warp_point` of `warper_rotations`) is exactly A and the
    backward map its inverse; other projections pass through."""
    from image_stitching_tpu.ops import warps as jwarps
    from image_stitching_tpu_torch.ops import warps
    k = np.eye(3, dtype=np.float32)
    th = 0.05
    h = np.array([[np.cos(th), -np.sin(th), 30.5],
                  [np.sin(th), np.cos(th), -12.25], [0, 0, 1]], np.float32)
    jw = jwarps.make_warper("affine", 1.0)
    roi = jw.warp_roi((60, 80), k, h)
    want = jw.warp_backward_coords(roi, k, h)
    us = roi[0] + np.arange(roi[2], dtype=np.float32)
    vs = roi[1] + np.arange(roi[3], dtype=np.float32)
    got = warps.camera_backward_xy("affine", t(us), t(vs), t(k), t(h), 1.0)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-3)
    tw = warps.make_warper("affine", 1.0)
    pts = np.float32([[0, 0], [79, 0], [40.5, 30.25], [0, 59]])
    for s in (0.97, 1.03):
        a = np.array([[s * np.cos(th), -s * np.sin(th), 30.5],
                      [s * np.sin(th), s * np.cos(th), -12.25], [0, 0, 1]])
        hw = warps.warper_rotations("affine", a[None])[0]
        u, v = tw.warp_point(pts, k, hw)
        fwd = pts @ a[:2, :2].T + a[:2, 2]
        np.testing.assert_allclose(np.stack([u, v], -1), fwd, atol=1e-3)
        sx, sy, valid = warps.camera_backward_xy(
            "affine", t(fwd[:, 0]), t(fwd[:, 1]), t(k), t(hw), 1.0)
        assert bool(valid.all())
        np.testing.assert_allclose(np.diagonal(n(sx)), pts[:, 0], atol=1e-3)
        np.testing.assert_allclose(np.diagonal(n(sy)), pts[:, 1], atol=1e-3)
    r = Rotation.from_euler("yx", [0.2, 0.1]).as_matrix().astype(np.float32)
    np.testing.assert_array_equal(
        warps.warper_rotations("spherical", r[None])[0], r)
    for a, b in zip(warps.camera_backward_xy("spherical", t(us), t(vs),
                                             t(k), t(r), 50.0),
                    warps.backward_xy_1d("spherical", t(us), t(vs), t(k),
                                         t(r), 50.0)):
        assert np.array_equal(n(a), n(b))
