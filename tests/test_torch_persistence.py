"""Port parity: the checkpoint readers (`core/persistence.py`) against the
reference's, on files both packages write and on hand-authored lines in
the C++ reference's format."""

import numpy as np
import pytest

from image_stitching_tpu.core import persistence as jpersist
from image_stitching_tpu.geometry.camera import Cameras as JCameras
from image_stitching_tpu_torch.core import persistence
from image_stitching_tpu_torch.interop import cameras_from_numpy


def _fields(seed, n=4):
    rng = np.random.default_rng(seed)
    return dict(focal=rng.uniform(100, 3000, n).astype(np.float32),
                aspect=rng.uniform(0.9, 1.1, n).astype(np.float32),
                ppx=rng.uniform(50, 1700, n).astype(np.float32),
                ppy=rng.uniform(40, 1300, n).astype(np.float32),
                R=rng.normal(size=(n, 3, 3)).astype(np.float32),
                t=rng.normal(size=(n, 3)).astype(np.float32) * 1e-4)


def _same(cams, jcams):
    got = cams.numpy()
    for name in ("focal", "aspect", "ppx", "ppy", "R", "t"):
        want = np.asarray(getattr(jcams, name))
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_round_trip_through_both_packages(tmp_path, writer):
    """Each package writes cams.data and indices.data; both readers give
    the same cameras and indices, within 6 significant digits of what was
    written."""
    fields = _fields(1)
    if writer == "jax":
        jpersist.serialize_camera_params(JCameras(**fields), str(tmp_path))
        jpersist.serialize_indices([0, 2, 5, 6], str(tmp_path))
    else:
        persistence.serialize_camera_params(
            cameras_from_numpy(JCameras(**fields), device="cpu"),
            str(tmp_path))
        persistence.serialize_indices([0, 2, 5, 6], str(tmp_path))
    cams = persistence.deserialize_camera_params(str(tmp_path), device="cpu")
    _same(cams, jpersist.deserialize_camera_params(str(tmp_path)))
    for name, want in fields.items():
        np.testing.assert_allclose(cams.numpy()[name], want, rtol=1e-5,
                                   atol=1e-9)
    assert persistence.deserialize_indices(str(tmp_path)) == \
        jpersist.deserialize_indices(str(tmp_path)) == [0, 2, 5, 6]


CPP_LINES = (
    "1@1234.57@612@408@[0;0;0;]@[0.999848,0,-0.0174524;0,1,0;"
    "0.0174524,0,0.999848;]\n"
    "0.999999@2.5e+03@1.2e+03@8.16e+02@[1e-05;-2.5e-07;0;]@"
    "[1,-1.2e-05,3.4e-07;1.2e-05,1,-6e-06;-3.4e-07,6e-06,1;]\n"
    "\n"
    "1@ 856.108@480@ 270@[ 0; 0; 0;]@[-0.5,0,0.866025;0,1,0;"
    "-0.866025,0,-0.5;]\n")


def test_hand_authored_cpp_lines(tmp_path):
    """Lines as the C++ reference writes them (6 significant digits,
    scientific notation, a blank line, spaces) parse to the reference's
    values."""
    (tmp_path / "cams.data").write_text(CPP_LINES)
    (tmp_path / "indices.data").write_text("0\n3\n\n7\n")
    cams = persistence.deserialize_camera_params(str(tmp_path), device="cpu")
    _same(cams, jpersist.deserialize_camera_params(str(tmp_path)))
    assert len(cams) == 3
    assert float(cams.focal[1]) == 2500.0
    assert float(cams.t[1, 1]) == np.float32(-2.5e-07)
    assert persistence.deserialize_indices(str(tmp_path)) == \
        jpersist.deserialize_indices(str(tmp_path)) == [0, 3, 7]
    for text in ("[1,2;3,4;]", "[1.5e-3;2e+2;]", "[7;]", " [0.1,0.2,0.3;] "):
        np.testing.assert_array_equal(persistence.deserialize_matrix(text),
                                      jpersist.deserialize_matrix(text))
