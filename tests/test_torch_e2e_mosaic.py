"""Port parity of what mosaic100 adds to the registration (bench.py's
100-tile narrow-fov ring with range_width=3):

- the range matcher through `stitch()` on tests/test_pipeline_e2e.py's
  narrow-fov mosaic (8 x 120x160, 12 deg, overlap 0.55, detailed
  texture, range_width=3), against the JAX package's stitch, both
  drawing RANSAC from split(PRNGKey(seed), 13): the pair lists and kept
  indices equal;
- bundle adjustment past 64 cameras, where both packages switch the LM
  inner solver from Cholesky to Jacobi-preconditioned CG ("cg64"), on one
  packed problem of synthetic correspondences of a 72-camera ring.
"""

import importlib

import numpy as np
from scipy.spatial.transform import Rotation

from _torch_port import Recorder, checked_keys, n
from image_stitching_tpu.config import StitchConfig as JConfig
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu.geometry.camera import Cameras as JCameras
from image_stitching_tpu.pipeline.stitcher import stitch as jstitch
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.estimation import bundle_adjust as tba
from image_stitching_tpu_torch.interop import cameras_from_numpy
from image_stitching_tpu_torch.pipeline import stitcher
from image_stitching_tpu_torch.pipeline.stitcher import stitch

# The reference's packages re-export functions under their module names.
jstitcher = importlib.import_module("image_stitching_tpu.pipeline.stitcher")
jba = importlib.import_module("image_stitching_tpu.estimation.bundle_adjust")

MOSAIC = dict(num_features=300, range_width=3, expos_comp_type="gain",
              blend_type="no", compose_megapix=-1, seam_megapix=0.02)


def test_range_matcher_mosaic_pairs_equal(tmp_path):
    """range_width=3 matches each image with its next two: both packages
    list the same 13 pairs and keep all 8 images."""
    d = tmp_path / "mosaic"
    images, k, rs = make_ring_captures(
        n_images=8, hw=(120, 160), fov_deg=12, overlap_ratio=0.55,
        seed=9, texture_detail=True)
    write_capture_dir(str(d), images, k, rs)
    runs = [tmp_path / "run_jax", tmp_path / "run_torch"]
    for run in runs:
        run.mkdir()
    jrec = Recorder(jstitcher, "match_all_pairs")
    with jrec:
        ref = jstitch(str(d), JConfig(checkpoint_dir=str(runs[0]),
                                      **MOSAIC), output="")
    rec = Recorder(stitcher, "match_all_pairs")
    with rec, checked_keys(JConfig().seed, 13) as drawn:
        got = stitch(str(d), StitchConfig(checkpoint_dir=str(runs[1]),
                                          **MOSAIC),
                     output="", device="cpu")
    assert drawn[0] == 13
    (_, _, jpm), = jrec.calls["match_all_pairs"]
    (_, _, tpm), = rec.calls["match_all_pairs"]
    tpm = tpm.numpy()
    want = list(zip(np.asarray(jpm.ii).tolist(), np.asarray(jpm.jj).tolist()))
    assert want == [(i, j) for i in range(8) for j in (i + 1, i + 2)
                    if j < 8]
    assert list(zip(np.asarray(tpm.ii).tolist(),
                    np.asarray(tpm.jj).tolist())) == want
    assert got.kept_indices == ref.kept_indices == list(range(8))
    assert float(n(got.mask).mean()) > 0.9


def _cluster_problem(n_cams=72, hw=(240, 320), fov_deg=40.0, per_pair=40,
                     seed=0):
    """n_cams cameras looking within 4 degrees of one direction (ground
    truth K, Rs), and the packed correspondences of each camera with those
    1, 5, 17 and 31 places on (mod n_cams), a well-connected graph on
    which CG's 64 iterations converge: points drawn in camera a, carried
    to camera b by K R_b^T R_a K^-1 (the reproj cost's model) and kept
    inside b, with 0.2 px noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    focal = (w / 2) / np.tan(np.radians(fov_deg) / 2)
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    rs = Rotation.from_rotvec(rng.uniform(-1, 1, (n_cams, 3))
                              * np.radians(4.0)).as_matrix()
    cam_i, cam_j, p_i, p_j = [], [], [], []
    for a in range(n_cams):
        for d in (1, 5, 17, 31):
            i, j = sorted((a, (a + d) % n_cams))
            p = rng.uniform((0, 0), (w, h), (2 * per_pair, 2))
            q = (k @ rs[j].T @ rs[i] @ np.linalg.inv(k)
                 @ np.c_[p, np.ones(len(p))].T).T
            q = q[:, :2] / q[:, 2:]
            keep = np.all((q >= 0) & (q < (w, h)), axis=1)
            p, q = p[keep][:per_pair], q[keep][:per_pair]
            assert len(p) == per_pair
            cam_i += [i] * per_pair
            cam_j += [j] * per_pair
            p_i.append(p + rng.normal(0, 0.2, p.shape))
            p_j.append(q + rng.normal(0, 0.2, q.shape))
    q_n = len(cam_i)
    pad = 256
    while pad < q_n:
        pad *= 2
    pad -= q_n
    packed = dict(
        cam_i=np.pad(np.asarray(cam_i, np.int32), (0, pad)),
        cam_j=np.pad(np.asarray(cam_j, np.int32), (0, pad),
                     constant_values=1),
        p_i=np.pad(np.concatenate(p_i).astype(np.float32),
                   ((0, pad), (0, 0))),
        p_j=np.pad(np.concatenate(p_j).astype(np.float32),
                   ((0, pad), (0, 0))),
        w=np.pad(np.ones(q_n, np.float32), (0, pad)))
    return k, rs, packed


def _rel_deg(ra, rb, a: int, b: int) -> float:
    """Angle (degrees) between the relative rotations R_b^T R_a of two
    camera sets, in float64 through the quaternion (arccos of the trace
    cannot resolve angles below ~0.03 degrees from float32 matrices)."""
    ra, rb = np.asarray(ra, np.float64), np.asarray(rb, np.float64)
    return float(np.degrees(Rotation.from_matrix(
        (ra[b].T @ ra[a]) @ (rb[b].T @ rb[a]).T).magnitude()))


def test_bundle_adjust_cg64_past_64_cameras(monkeypatch):
    """72 cameras, rotations seeded 0.2 degrees off: both packages take
    the CG inner solver; every relative rotation within 1e-3 degrees of
    the JAX package's, and the cost down to the noise (within 0.1 degrees
    of the truth)."""
    k, rs, packed = _cluster_problem()
    n_cams = len(rs)
    seed_r = (Rotation.from_rotvec(np.random.default_rng(1).normal(
        0, np.radians(0.2), (n_cams, 3))) * Rotation.from_matrix(rs)
    ).as_matrix().astype(np.float32)
    ones = np.ones(n_cams, np.float32)
    cams = JCameras(focal=ones * np.float32(k[0, 0]), aspect=ones,
                    ppx=ones * np.float32(k[0, 2]),
                    ppy=ones * np.float32(k[1, 2]), R=seed_r,
                    t=np.zeros((n_cams, 3), np.float32))
    solvers = []
    inner = tba._inner_solve

    def recording(a, b, solver):
        solvers.append(solver)
        return inner(a, b, solver)
    monkeypatch.setattr(tba, "_inner_solve", recording)
    ref = jba.bundle_adjust(cams, jba.BAProblem(**packed))
    got = tba.bundle_adjust(cameras_from_numpy(cams, device="cpu"),
                            tba.BAProblem(**packed)).numpy()
    assert solvers and set(solvers) == {"cg64"}
    np.testing.assert_array_equal(got["focal"], np.asarray(ref.focal))
    pairs = [(a, b) for a in range(n_cams) for b in range(a + 1, n_cams)]
    assert max(_rel_deg(got["R"], ref.R, a, b) for a, b in pairs) <= 1e-3
    assert max(_rel_deg(got["R"], rs, a, b) for a, b in pairs) <= 0.1
    assert max(_rel_deg(seed_r, rs, a, b) for a, b in pairs) > 0.5
