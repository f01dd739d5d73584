"""Port parity of `geometry/quaternion.py` and of the public helpers no
stitch path reaches: every quaternion function against the JAX package's
on random batches (numpy seeded) within 1e-6 in float32, every Euler
order; `get_fov`, `rad_to_deg`/`deg_to_rad`, `resize_scale`, `box_blur`,
`imread_batch`, the native `read_images`/`write_jpeg`/`dp_seam`,
`format_image_description`, `make_cv_pattern` and `fast_score_map`
against their counterparts."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import n
from image_stitching_tpu.core import exif as jexif
from image_stitching_tpu.core import image_io as jio
from image_stitching_tpu.core import native as jnative
from image_stitching_tpu.geometry import camera as jcamera
from image_stitching_tpu.geometry import quaternion as jq
from image_stitching_tpu.geometry import rotation as jrot
from image_stitching_tpu.geometry.euler_order import EulerOrder
from image_stitching_tpu.ops import imgproc as jimg
from image_stitching_tpu.ops.features import orb as jorb
from image_stitching_tpu_torch import geometry
from image_stitching_tpu_torch.core import exif, image_io, native
from image_stitching_tpu_torch.geometry import quaternion as tq
from image_stitching_tpu_torch.geometry.camera import Cameras, get_fov
from image_stitching_tpu_torch.geometry.rotation import (deg_to_rad,
                                                         rad_to_deg)
from image_stitching_tpu_torch.ops import imgproc
from image_stitching_tpu_torch.ops.features import orb

RNG = np.random.default_rng(11)
N = 64


def _quats(n_q=N, rng=RNG):
    q = rng.normal(size=(n_q, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("order", [o.value for o in EulerOrder])
def test_from_euler_every_order(order):
    e = RNG.uniform(-np.pi, np.pi, (N, 3)).astype(np.float32)
    want = jq.from_euler(jnp.asarray(e), EulerOrder(order))
    _close(tq.from_euler(torch.as_tensor(e), order), want)
    _close(tq.from_euler(torch.as_tensor(e), EulerOrder(order)), want)


def test_euler_orders_exported():
    assert set(geometry.ALL_ORDERS) == {o.value for o in EulerOrder}
    with pytest.raises(ValueError, match="unknown euler order"):
        tq.from_euler(torch.zeros(3), "XXY")


UNARY = ["to_rotation_matrix", "conjugate", "invert", "norm", "normalize"]
BINARY = ["multiply", "dot", "angle_to"]


@pytest.mark.parametrize("name", UNARY)
def test_unary(name):
    q = _quats() * RNG.uniform(0.5, 2.0, (N, 1)).astype(np.float32)
    _close(getattr(tq, name)(torch.as_tensor(q)),
           getattr(jq, name)(jnp.asarray(q)))


@pytest.mark.parametrize("name", BINARY)
def test_binary(name):
    a, b = _quats(), _quats()
    _close(getattr(tq, name)(torch.as_tensor(a), torch.as_tensor(b)),
           getattr(jq, name)(jnp.asarray(a), jnp.asarray(b)))


def test_angle_to_in_float64():
    """In float64 angle_to is 2 acos |a . b| to 1e-12."""
    a, b = _quats().astype(np.float64), _quats().astype(np.float64)
    want = 2.0 * np.arccos(np.clip(np.abs(np.sum(a * b, -1)), -1, 1))
    _close(tq.angle_to(torch.as_tensor(a), torch.as_tensor(b)), want, 1e-12)


def test_identity_normalize_zero_and_axis_angle():
    _close(tq.identity(), jq.identity())
    _close(tq.normalize(torch.zeros((2, 4))), jq.normalize(jnp.zeros((2, 4))))
    axis = RNG.normal(size=(N, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = RNG.uniform(-np.pi, np.pi, N).astype(np.float32)
    _close(tq.from_axis_angle(torch.as_tensor(axis), torch.as_tensor(ang)),
           jq.from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)))


def test_from_rotation_matrix_every_branch():
    """Random rotations plus ones that take each Shepperd branch."""
    from scipy.spatial.transform import Rotation as R
    m = R.from_quat(_quats()).as_matrix().astype(np.float32)
    special = np.stack([np.diag(d).astype(np.float32) for d in
                        ([1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    m = np.concatenate([m, special])
    _close(tq.from_rotation_matrix(torch.as_tensor(m)),
           jq.from_rotation_matrix(jnp.asarray(m)))


def test_from_unit_vectors_with_antiparallel():
    v = RNG.normal(size=(N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = RNG.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[:4] = -v[:4]
    v[2:4] = [[0.0, 0.3, 0.9539392], [0.9539392, 0.3, 0.0]]
    w[2:4] = -v[2:4]
    _close(tq.from_unit_vectors(torch.as_tensor(v), torch.as_tensor(w)),
           jq.from_unit_vectors(jnp.asarray(v), jnp.asarray(w)))


def test_slerp_and_rotate_towards():
    a, b = _quats(), _quats()
    b[:3] = a[:3]                       # parallel: the nlerp branch
    b[3:6] = -a[3:6]                    # the sign flip
    t = RNG.uniform(0, 1, N).astype(np.float32)
    _close(tq.slerp(*(torch.as_tensor(x) for x in (a, b, t))),
           jq.slerp(*(jnp.asarray(x) for x in (a, b, t))))
    step = RNG.uniform(0, 1, N).astype(np.float32)
    _close(tq.rotate_towards(*(torch.as_tensor(x) for x in (a, b, step))),
           jq.rotate_towards(*(jnp.asarray(x) for x in (a, b, step))))


def test_apply_to_vector():
    q = _quats()
    v = RNG.normal(size=(N, 3)).astype(np.float32)
    _close(tq.apply_to_vector(torch.as_tensor(q), torch.as_tensor(v)),
           jq.apply_to_vector(jnp.asarray(q), jnp.asarray(v)))


def test_get_fov_and_angle_units():
    f = RNG.uniform(100, 900, 5).astype(np.float32)
    pp = RNG.uniform(50, 400, (2, 5)).astype(np.float32)
    rs = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    args = (f, np.ones(5, np.float32), pp[0], pp[1], rs,
            np.zeros((5, 3), np.float32))
    want = jcamera.get_fov(jcamera.Cameras(*(jnp.asarray(a) for a in args)))
    got = get_fov(Cameras.from_numpy(*args, device="cpu"))
    for g, w in zip(got, want):
        _close(g, w)
    x = RNG.uniform(-10, 10, 16).astype(np.float32)
    _close(rad_to_deg(torch.as_tensor(x)), jrot.rad_to_deg(jnp.asarray(x)))
    _close(deg_to_rad(torch.as_tensor(x)), jrot.deg_to_rad(jnp.asarray(x)))
    assert geometry.rad_to_deg is rad_to_deg and geometry.get_fov is get_fov


@pytest.mark.parametrize("scale", [0.5, 0.37, 1.3])
def test_resize_scale(scale):
    img = RNG.uniform(0, 255, (37, 51, 3)).astype(np.float32)
    _close(imgproc.resize_scale(torch.as_tensor(img), scale),
           jimg.resize_scale(jnp.asarray(img), scale), 1e-3)


@pytest.mark.parametrize("size,shape", [(3, (20, 30)), (5, (17, 23, 3))])
def test_box_blur(size, shape):
    img = RNG.uniform(0, 255, shape).astype(np.float32)
    _close(imgproc.box_blur(torch.as_tensor(img), size),
           jimg.box_blur(jnp.asarray(img), size), 1e-4)


def _pngs(tmp_path, count=3):
    paths = []
    for i in range(count):
        img = RNG.integers(0, 256, (20 + 3 * i, 30 + i, 3), dtype=np.uint8)
        path = os.path.join(tmp_path, f"{i}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths


def test_imread_batch_and_read_images(tmp_path):
    """The threaded native batch decode, through imread_batch and alone,
    equals PIL's decode of each PNG of three sizes, and the reference's on
    files of one size.  (The reference cuts a smaller file's slot with the
    largest file's row stride, so its pixels there are not the file's.)"""
    paths = _pngs(tmp_path)
    want = [np.asarray(Image.open(p).convert("RGB")) for p in paths]
    for got in (image_io.imread_batch(paths, 2), native.read_images(paths)):
        assert [g.shape for g in got] == [w.shape for w in want]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    same = [paths[-1]] * 2
    for g, w in zip(image_io.imread_batch(same), jio.imread_batch(same)):
        assert np.array_equal(g, w)
    assert native.read_images([]) is None
    assert native.read_images([os.path.join(tmp_path, "none.png")]) is None


def test_write_jpeg(tmp_path):
    """write_jpeg gives the reference's file byte for byte, and its
    ImageDescription payload reads back."""
    img = RNG.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    text = exif.camera_to_image_description(300.0, 20.0, 12.0, np.eye(3))
    got, want = (os.path.join(tmp_path, f"{x}.jpg") for x in ("t", "j"))
    assert native.write_jpeg(got, img, 90, text)
    if jnative.lib is not None:
        assert jnative.write_jpeg(want, img, 90, text)
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
    assert native.exif_description(got) == text
    assert Image.open(got).size == (40, 24)
    assert not native.write_jpeg(os.path.join(tmp_path, "no", "x.jpg"), img)


def test_dp_seam():
    """The native min-cost vertical seam equals a numpy DP with the same
    tie order (left, up, right), and the reference's."""
    cost = RNG.uniform(0, 1, (30, 17)).astype(np.float32)
    got = native.dp_seam(cost)
    if jnative.lib is not None:
        assert np.array_equal(got, jnative.dp_seam(cost))
    acc = cost[0].astype(np.float32).copy()
    steps = [acc]
    for y in range(1, cost.shape[0]):
        left = np.r_[np.inf, acc[:-1]]
        right = np.r_[acc[1:], np.inf]
        acc = cost[y] + np.minimum(np.minimum(left, acc), right)
        steps.append(acc)
    total = float(sum(cost[y, got[y]] for y in range(cost.shape[0])))
    assert np.isclose(total, float(steps[-1].min()), rtol=1e-5)
    assert np.all(np.abs(np.diff(got)) <= 1)


def test_format_image_description():
    m = RNG.normal(size=(4, 4))
    k = RNG.normal(size=(3, 3))
    args = (True, 12.5, np.eye(4), m, np.linalg.inv(m), k)
    got = exif.format_image_description(*args)
    assert got == jexif.format_image_description(*args)
    assert exif.parse_image_description(got).compass_angle == 12.5
    r = RNG.normal(size=(3, 3))
    r = np.linalg.qr(r)[0] * np.sign(np.linalg.det(np.linalg.qr(r)[0]))
    assert (exif.camera_to_image_description(500.0, 10.0, 8.0, r) ==
            jexif.camera_to_image_description(500.0, 10.0, 8.0, r))


def test_make_cv_pattern_and_fast_score_map():
    assert np.array_equal(orb.make_cv_pattern(), jorb.make_cv_pattern())
    assert np.array_equal(orb.resolve_pattern("cv"), jorb.make_cv_pattern())
    img = RNG.uniform(0, 255, (40, 52)).astype(np.float32)
    got = orb.fast_score_map(torch.as_tensor(img), 20.0)
    assert got.dtype == torch.float32
    assert np.array_equal(n(got), np.asarray(jorb.fast_score_map(
        jnp.asarray(img), 20.0)))
