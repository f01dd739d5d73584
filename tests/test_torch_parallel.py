"""Port parity of the scale-out layer's canvas side: `parallel/mesh.py`,
`parallel/canvas.py` and `pipeline/compose_fused.py::
fused_compose_sharded`.

The scenes are tests/test_parallel.py's (3 noise images of 48x64, focal
40, yaws 0.5 i, spherical).  The JAX side runs on the conftest's 8
virtual CPU devices, the port on meshes that name the CPU once per shard.
The sharded compose is held against the JAX sharded compose on the same
shard count (mask equal, pixels within 1) and against the port's
`fused_compose` with the JAX test's bounds (mean |diff| < 0.5 and p99 <= 2;
FEATHER exact).  The stand-alone composites are held against the JAX
ones: their float32 backward maps round differently on the two sides
(XLA's fused sin/cos and multiply-adds; 5% of float32 sines differ by an
ulp), and on noise images an ulp of a sample coordinate moves a pixel by
up to ~0.05, so the feather composite is held within 0.1 (mean 1e-3), the
multiband one within 1e-2; each is sharding-invariant in the port to
1e-6.  The halo blur is bit-equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP
from scipy.spatial.transform import Rotation as R

from image_stitching_tpu.config import BlenderType as JBlender
from image_stitching_tpu.ops.warps import make_warper as j_make_warper
from image_stitching_tpu.parallel import canvas as jcanvas
from image_stitching_tpu.parallel import make_mesh as j_make_mesh
from image_stitching_tpu.pipeline import compose_fused as jcf
from image_stitching_tpu_torch.config import BlenderType
from image_stitching_tpu_torch.ops.warps import make_warper
from image_stitching_tpu_torch.parallel import canvas as tcanvas
from image_stitching_tpu_torch.parallel.mesh import (make_mesh, on_device,
                                                     shard_batch)
from image_stitching_tpu_torch.pipeline import compose_fused as tcf

CPU = torch.device("cpu")


def _scene(n=3, h=48, w=64, focal=40.0):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    ks = np.tile(np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                          np.float32), (n, 1, 1))
    rs = np.stack([R.from_euler("y", 0.5 * i).as_matrix().astype(np.float32)
                   for i in range(n)])
    return imgs, ks, rs


def _cpu_mesh(n_dev, dp=1):
    return make_mesh((dp, n_dev), ("dp", "sp"), devices=[CPU] * (dp * n_dev))


@pytest.mark.parametrize("shape,devices,want", [
    (None, 8, {"dp": 8, "sp": 1}), ((2, 4), 8, {"dp": 2, "sp": 4}),
    ((1, 4), 8, {"dp": 1, "sp": 4}), ((4, 2), 8, {"dp": 4, "sp": 2})])
def test_make_mesh_shapes(shape, devices, want):
    """Shapes as the reference's make_mesh gives them; a device may stand
    in several places; too few devices raise."""
    mesh = make_mesh(shape, ("dp", "sp"), devices=[CPU] * devices)
    assert mesh.shape == want
    assert len(mesh.axis_devices("sp")) == want["sp"]
    assert all(d == CPU for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="needs"):
        make_mesh((3, 4), devices=[CPU] * devices)


def test_make_mesh_defaults_to_cuda():
    """With no devices given the mesh is every CUDA device; without one it
    raises, never taking the CPU."""
    if torch.cuda.is_available():
        assert make_mesh().devices.flat[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_shard_batch_splits_dp_rows():
    mesh = _cpu_mesh(2, dp=4)
    x = torch.arange(8 * 3).reshape(8, 3)
    parts = shard_batch(mesh, "dp").shard(x)
    assert len(parts) == 4 and torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, "dp").shard(x[:6])
    with on_device(CPU):
        pass


def test_halo_blur_matches_reference():
    """The 5-tap blur with the 2-column halo copied between shards equals
    the reference's ppermute blur within 1e-6 (bit-equal)."""
    x = np.random.default_rng(1).uniform(0, 255, (12, 32, 3)).astype(
        np.float32)
    mesh = j_make_mesh((1, 4), ("dp", "sp"))
    blur = jax.jit(shard_map(lambda a: jcanvas._halo_blur(a, "sp"),
                             mesh=mesh, in_specs=JP(None, "sp", None),
                             out_specs=JP(None, "sp", None)))
    want = np.asarray(blur(jnp.asarray(x)))
    got = torch.cat(tcanvas._halo_blur(list(torch.as_tensor(x).chunk(
        4, dim=1))), dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


COMPOSITE_ARGS = (3, (48, 64), (96, 256), (-128, 40), 40.0)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_composite_matches_reference(n_dev):
    imgs, ks, rs = _scene()
    want = np.asarray(jcanvas.make_sharded_composite(
        j_make_mesh((2, 4), ("dp", "sp")), *COMPOSITE_ARGS)(
            jnp.asarray(imgs), jnp.asarray(ks), jnp.asarray(rs)))
    fn = tcanvas.make_sharded_composite(_cpu_mesh(n_dev), *COMPOSITE_ARGS)
    got = fn(imgs, ks, rs).numpy()
    assert got.shape == want.shape == (96, 256, 3)
    diff = np.abs(got - want)
    assert float(diff.max()) <= 0.1 and float(diff.mean()) <= 1e-3, (
        float(diff.max()), float(diff.mean()))
    one = tcanvas.make_sharded_composite(_cpu_mesh(1), *COMPOSITE_ARGS)
    np.testing.assert_allclose(got, one(imgs, ks, rs).numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_multiband_matches_reference(n_dev):
    imgs, ks, rs = _scene()
    weights = np.ones((3, 48, 64), np.float32)
    want = np.asarray(jcanvas.make_sharded_multiband(
        j_make_mesh((1, 4), ("dp", "sp")), *COMPOSITE_ARGS, n_bands=2)(
            *(jnp.asarray(a) for a in (imgs, ks, rs, weights))))
    got = tcanvas.make_sharded_multiband(
        _cpu_mesh(n_dev), *COMPOSITE_ARGS, n_bands=2)(imgs, ks, rs,
                                                      weights).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    one = tcanvas.make_sharded_multiband(_cpu_mesh(1), *COMPOSITE_ARGS,
                                         n_bands=2)(imgs, ks, rs, weights)
    np.testing.assert_allclose(got, one.numpy(), rtol=0, atol=1e-6)


def _compose_args(blend):
    """test_parallel.py's sharded-compose scene: (JAX args, port args)."""
    imgs, ks, rs = _scene()
    warper = j_make_warper("spherical", 40.0)
    corners, sizes = [], []
    for i in range(3):
        x, y, w, h = warper.warp_roi((48, 64), ks[i], rs[i])
        corners.append((x, y))
        sizes.append((w, h))
    masks = [np.full((s[1], s[0]), 255, np.uint8) for s in sizes]
    tail = (corners, sizes, masks, corners, 1.0, None)
    return ((jnp.asarray(imgs), ks, rs, warper) + tail
            + (getattr(JBlender, blend), 5.0),
            (torch.as_tensor(imgs), ks, rs, make_warper("spherical", 40.0))
            + tail + (getattr(BlenderType, blend), 5.0))


@pytest.mark.parametrize("blend", ["MULTI_BAND", "FEATHER"])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_fused_compose_sharded_matches_reference(n_dev, blend):
    """The port's n-shard compose against the JAX sharded compose on the
    same number of shards: masks equal, pixels within 1."""
    jargs, targs = _compose_args(blend)
    want, want_mask = jcf.fused_compose_sharded(
        j_make_mesh((1, n_dev), ("dp", "sp")), *jargs)
    got, got_mask = tcf.fused_compose_sharded(_cpu_mesh(n_dev), *targs)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    assert np.array_equal(got_mask, np.asarray(want_mask))
    assert float(np.abs(got - want)[got_mask].max()) <= 1.0


@pytest.mark.parametrize("blend", ["MULTI_BAND", "FEATHER"])
def test_fused_compose_sharded_matches_fused(blend):
    """tests/test_parallel.py's bounds on the port: the 4-shard compose
    against the port's fused_compose, mean |diff| < 0.5 and p99 <= 2 over
    both masks; FEATHER exact."""
    _, targs = _compose_args(blend)
    pano1, m1 = tcf.fused_compose(*targs)
    pano4, m4 = tcf.fused_compose_sharded(_cpu_mesh(4), *targs)
    assert pano4.shape == tuple(pano1.shape) and m4.shape == tuple(m1.shape)
    both = m1.numpy() & m4
    assert both.any()
    diff = np.abs(pano4 - pano1.numpy())[both]
    if blend == "FEATHER":
        assert float(diff.max()) == 0.0, float(diff.max())
    else:
        assert float(np.mean(diff)) < 0.5, float(np.mean(diff))
        assert float(np.percentile(diff, 99)) <= 2.0


def test_shard_frames_follow_the_reference_geometry():
    """The canvas rounded to n_dev * 2^max(nb, 1) wide and 2^max(nb, 1)
    high, margin max(3 * 2^nb, 2^rounds for FEATHER), one frame per shard
    that holds every image over it."""
    _, targs = _compose_args("MULTI_BAND")
    canvas = (-5, 3, 93, 43)
    for blend, n_dev in ((BlenderType.MULTI_BAND, 4),
                         (BlenderType.FEATHER, 3)):
        w_local, margin, frames = tcf._shard_frames(canvas, blend, 5.0,
                                                    n_dev, 3)
        nb, sharp, rounds = tcf._blend_params(canvas, blend, 5.0)
        step = 1 << max(nb, 1)
        assert (w_local * n_dev) % (n_dev * step) == 0
        assert w_local * n_dev >= canvas[2] > w_local * n_dev - n_dev * step
        assert margin == max(3 << nb, (1 << rounds) if sharp else 0)
        for s, g in enumerate(frames):
            assert g.canvas[0] == canvas[0] + s * w_local - margin
            assert g.canvas_w == w_local + 2 * margin
            assert g.canvas_h % step == 0 and g.canvas_h >= canvas[3]
            assert g.buckets == {(g.canvas_h, g.canvas_w): [0, 1, 2]}
