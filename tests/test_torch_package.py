"""The port's package boundary: no jax at import, the compose dispatch,
explicit devices, host IO and the state conversion from the reference."""

import importlib
import inspect
import json
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_stitching_tpu_torch as port_pkg
from _torch_port import n, t
from image_stitching_tpu.core import exif as jexif
from image_stitching_tpu.core import persistence as jpersist
from image_stitching_tpu.data import synth as jsynth
from image_stitching_tpu.geometry.camera import Cameras as JCameras
from image_stitching_tpu.ops.features.orb import orb_detect_and_describe
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.core import exif, image_io, persistence
from image_stitching_tpu_torch.data import synth
from image_stitching_tpu_torch.interop import (cameras_from_numpy,
                                               features_from_numpy)
from image_stitching_tpu_torch.kernels.hamming import hamming_two_nn_pairs
from image_stitching_tpu_torch.kernels.multiband import pyramid_accumulate
from image_stitching_tpu_torch.kernels.orb_sample import orb_sample_levels
from image_stitching_tpu_torch.kernels.warp_gather import warp_bilinear
from image_stitching_tpu_torch.pipeline import stitcher
from image_stitching_tpu_torch.pipeline.stitcher import stitch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import image_stitching_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "image_stitching_tpu.")))
print(json.dumps({"names": names, "bad": bad}))
assert not bad, bad
"""

# The modules of the registration variants, imported with the rest.
REGISTRATION_MODULES = (
    "core.rig", "estimation.homography_estimator", "estimation.pose_infill",
    "estimation.bundle_adjust", "geometry.euler", "geometry.rotation",
    "ops.ransac", "ops.matching", "data.synth")
# The detectors, imported with the rest.
DETECTOR_MODULES = ("ops.features.hessian", "ops.features.surf",
                    "ops.features.akaze", "ops.features.sift")
# The scale-out layer and the quaternion library, imported with the rest.
PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.canvas",
                    "parallel.batched", "parallel.distributed",
                    "geometry.quaternion")


def test_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout)
    names = seen["names"]
    assert len(names) >= 42 and seen["bad"] == []
    for mod in REGISTRATION_MODULES + DETECTOR_MODULES + PARALLEL_MODULES:
        assert f"image_stitching_tpu_torch.{mod}" in names, mod


SLICE = dict(fast_ingest=False, expos_comp_type="no", seam_find_type="no")


def _dispatch(monkeypatch, cfg, device, devices):
    """Run stitcher.compose_uniform on a tiny canvas with `devices` CUDA
    devices, each compose replaced by a recorder.  Returns the calls as
    (name, mesh or None)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
    calls = []

    def record(name):
        def fn(*args, **kw):
            mesh = args[0] if name == "sharded" else None
            calls.append((name, mesh))
            pano = np.zeros((2, 2, 3), np.float32)
            mask = np.ones((2, 2), bool)
            return pano, mask
        return fn
    monkeypatch.setattr(stitcher, "fused_compose_sharded", record("sharded"))
    monkeypatch.setattr(stitcher, "fused_compose_strips", record("strips"))
    monkeypatch.setattr(stitcher, "fused_compose", record("fused"))
    args = (None, None, None, None, [(0, 0), (30, 0)], [(40, 20), (40, 20)],
            None, None, 1.0, None, cfg.blend_type, cfg.blend_strength)
    stitcher.compose_uniform(args, cfg, device)
    return calls


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_options_outside_slice_raise(monkeypatch, devices):
    """The option the port once refused, the canvas sharded over more than
    one CUDA device, now runs: the dispatch calls fused_compose_sharded
    with a (1, n) mesh of the n CUDA devices; the same configuration on the
    CPU, and every detector without it on those devices, take
    fused_compose."""
    cfg = StitchConfig(**dict(SLICE, use_sharded_compose=True))
    ((name, mesh),) = _dispatch(monkeypatch, cfg, torch.device("cuda"),
                                devices)
    assert name == "sharded"
    assert mesh.shape == {"dp": 1, "sp": devices}
    assert mesh.axis_devices("sp") == [torch.device("cuda", i)
                                       for i in range(devices)]
    assert _dispatch(monkeypatch, cfg, torch.device("cpu"), devices) == [
        ("fused", None)]
    for feat in ("orb", "sift", "akaze", "surf"):
        cfg = StitchConfig(**dict(SLICE, features_type=feat))
        assert stitcher.compose_route(cfg, (0, 0, 70, 20), "cuda") == "fused"


@pytest.mark.parametrize("option,value", [
    ("seam_find_type", "voronoi"), ("seam_find_type", "gc_color"),
    ("seam_find_type", "gc_colorgrad"), ("use_sharded_compose", True),
    ("warp_type", "cylindrical"), ("warp_type", "transverseMercator"),
    ("blend_type", "feather"), ("blend_type", "no"),
    ("find_features", False), ("serialize_data", False),
    ("save_graph", True), ("profile_dir", "prof"),
    ("ba_cost_func", "ray"), ("ba_cost_func", "affine"),
    ("ba_cost_func", "no"), ("matcher_type", "affine"),
    ("estimator_type", "affine"), ("use_sensor_priors", False),
    ("infill_dropped", True), ("warp_type", "affine"), ("timelapse", True),
    ("crop_result", True), ("compose_strips_mp", 0.5),
    ("compose_strip_w", 256), ("features_type", "sift"),
    ("features_type", "akaze"), ("features_type", "surf")])
def test_options_inside_slice_accepted(monkeypatch, option, value):
    """Every option composes on the CPU and on one CUDA device without the
    canvas sharded: the whole canvas by fused_compose, or the strips for a
    canvas at compose_strips_mp or above."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = StitchConfig(**dict(SLICE, **{option: value}))
    for device in ("cpu", "cuda"):
        assert stitcher.compose_route(cfg, (0, 0, 70, 20), device) == "fused"
        want = "strips" if option == "compose_strips_mp" else "fused"
        assert stitcher.compose_route(cfg, (0, 0, 1000, 600),
                                      device) == want


def test_sharded_compose_refused_on_several_devices(monkeypatch):
    """use_sharded_compose shards the canvas only when more than one CUDA
    device is present: 2 devices take fused_compose_sharded on a (1, 2)
    mesh, 1 device and the CPU fused_compose, and without the option 2
    devices take fused_compose."""
    cfg = StitchConfig(**dict(SLICE, use_sharded_compose=True))
    ((name, mesh),) = _dispatch(monkeypatch, cfg, torch.device("cuda"), 2)
    assert name == "sharded" and mesh.shape == {"dp": 1, "sp": 2}
    assert _dispatch(monkeypatch, cfg, torch.device("cuda"), 1) == [
        ("fused", None)]
    assert _dispatch(monkeypatch, cfg, torch.device("cpu"), 2) == [
        ("fused", None)]
    assert _dispatch(monkeypatch, StitchConfig(**SLICE),
                     torch.device("cuda"), 2) == [("fused", None)]


def test_cuda_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        stitch(["a.jpg", "b.jpg"], StitchConfig(**SLICE), output="",
               device="cuda")


def _device_params():
    """(where, parameter, default) for every parameter whose name holds
    "device" of every public callable of the port: the module-level
    functions and classes each module defines, and their public methods,
    classmethods and staticmethods, `__init__` included."""
    found = []
    for info in pkgutil.walk_packages(port_pkg.__path__,
                                      port_pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__",
                                               None) != mod.__name__:
                continue
            members = [(name, obj)]
            if inspect.isclass(obj):
                for attr, member in vars(obj).items():
                    if attr.startswith("_") and attr != "__init__":
                        continue
                    if isinstance(member, (classmethod, staticmethod)):
                        member = member.__func__
                    if inspect.isfunction(member):
                        members.append((f"{name}.{attr}", member))
            for where, fn in members:
                if not callable(fn):
                    continue
                try:
                    sig = inspect.signature(fn)
                except (TypeError, ValueError):
                    continue
                for p in sig.parameters.values():
                    if "device" in p.name:
                        found.append((f"{info.name}.{where}", p.name,
                                      p.default))
    return found


def test_no_public_cpu_default():
    """Entry points run on the card unless the caller asks for the CPU:
    no public callable of the port defaults a device to the CPU (the
    blenders, the Timelapser, the camera and feature constructors, the
    checkpoint reader, fast ingest and the pyramid matrices default to
    "cuda", as stitch() does)."""
    found = _device_params()
    cpu = [(where, name, default) for where, name, default in found
           if isinstance(default, (str, torch.device))
           and str(default).startswith("cpu")]
    assert cpu == []
    cuda = {where for where, _, default in found
            if isinstance(default, (str, torch.device))
            and str(default) == "cuda"}
    for where in ("ops.blend.MultiBandBlender", "ops.blend.FeatherBlender",
                  "ops.blend.NoBlender", "ops.blend.make_blender",
                  "ops.timelapse.Timelapser", "ops.pyr_mat.down_mats",
                  "ops.pyr_mat.up_mats", "geometry.camera.Cameras.from_numpy",
                  "geometry.camera.Cameras.identity",
                  "core.persistence.deserialize_camera_params",
                  "pipeline.ingest.FastIngest",
                  "pipeline.ingest.start_fast_ingest",
                  "interop.cameras_from_numpy", "interop.features_from_numpy",
                  "interop.pair_matches_from_numpy",
                  "pipeline.stitcher.stitch"):
        assert f"image_stitching_tpu_torch.{where}" in cuda, where


def test_kernel_wrappers_never_fall_back():
    """A tensor on a device with no kernel raises; only CPU tensors take
    the plain version."""
    meta = torch.empty((40, 50), device="meta")
    lvl = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        orb_sample_levels([meta], [meta], torch.empty((3, 2), device="meta"),
                          lvl, torch.empty((2, 512), device="meta"), 20)
    with pytest.raises(ValueError, match="no kernel"):
        warp_bilinear(torch.empty((4, 5, 3), device="meta"), meta, meta)
    with pytest.raises(ValueError):
        orb_sample_levels([torch.zeros(40, 50)],
                          [torch.zeros(40, 50, device="meta")],
                          torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(2, 512), 20)
    desc = torch.empty((2, 5, 8), dtype=torch.int32, device="meta")
    valid = torch.empty((2, 5), dtype=torch.bool, device="meta")
    pair = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hamming_two_nn_pairs(desc, valid, pair, pair)
    with pytest.raises(ValueError):
        hamming_two_nn_pairs(torch.zeros((2, 5, 8), dtype=torch.int32),
                             valid, pair, pair)
    accs = [torch.empty((4, 16 >> b, 16 >> b), device="meta")
            for b in range(2)]
    with pytest.raises(ValueError, match="no kernel"):
        pyramid_accumulate(torch.empty((1, 3, 8, 8), device="meta"),
                           torch.empty((1, 8, 8), device="meta"), [(0, 0)],
                           accs, 1)
    with pytest.raises(ValueError):
        pyramid_accumulate(torch.zeros((1, 3, 8, 8)), torch.zeros((1, 8, 8)),
                           [(0, 0)], accs, 1)


def test_synth_renders_the_reference_scene():
    """Same formulas and draws: the port's ring equals the reference's to
    float32 rounding of the rotation (a few texture-boundary pixels)."""
    ref, k_ref, rs_ref = jsynth.make_ring_captures(n_images=2, hw=(48, 64))
    got, k, rs = synth.make_ring_captures(n_images=2, hw=(48, 64))
    np.testing.assert_allclose(k, k_ref)
    np.testing.assert_allclose(rs, rs_ref, atol=1e-6)
    for a, b in zip(got, ref):
        assert (np.abs(a - b) <= 1e-3).mean() >= 0.99


@pytest.mark.parametrize("detail", [False, True])
def test_synth_texture_detail_bit_equal(detail):
    """`detail` (mosaic100's narrow-fov texture) renders bit for bit as the
    reference does: the texture on one lon/lat grid, one view, and
    mosaic100's ring geometry at 60x80 (fov 8, overlap 0.55, seed 31)."""
    rng = np.random.default_rng(0)
    lon = rng.uniform(-np.pi, np.pi, (40, 50)).astype(np.float32)
    lat = rng.uniform(-1.4, 1.4, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        synth.sphere_texture_rgb(lon, lat, 31, detail),
        jsynth.sphere_texture_rgb(lon, lat, 31, detail=detail))
    k = np.array([[400.0, 0, 40], [0, 400.0, 30], [0, 0, 1]])
    np.testing.assert_array_equal(
        synth.render_view(k, np.eye(3), (60, 80), 31, detail),
        jsynth.render_view(k, np.eye(3), (60, 80), 31, detail=detail))
    got = synth.make_ring_captures(n_images=3, hw=(60, 80), fov_deg=8,
                                   overlap_ratio=0.55, seed=31,
                                   texture_detail=detail)
    ref = jsynth.make_ring_captures(n_images=3, hw=(60, 80), fov_deg=8,
                                    overlap_ratio=0.55, seed=31,
                                    texture_detail=detail)
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)


def test_capture_dir_priors_round_trip(tmp_path):
    images, k, rs = synth.make_ring_captures(n_images=2, hw=(40, 56))
    paths = synth.write_capture_dir(str(tmp_path), images, k, rs)
    assert image_io.list_images(str(tmp_path)) == paths
    desc = exif.read_image_description(paths[1])
    assert desc == jexif.read_image_description(paths[1])
    f, a, ppx, ppy, r, _ = exif.sensor_prior_to_camera(
        exif.parse_image_description(desc))
    want = jexif.sensor_prior_to_camera(jexif.parse_image_description(desc))
    assert (f, a, ppx, ppy) == want[:4]
    np.testing.assert_allclose(r, rs[1], atol=1e-5)
    img = image_io.orient_capture(image_io.imread(paths[0]), False)
    assert img.shape == (40, 56, 3)
    assert image_io.probe_oriented_size(paths[0], True) == (40, 56)
    assert image_io.codec_name() != "none"


def test_checkpoint_text_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    fields = dict(focal=rng.uniform(100, 300, 3).astype(np.float32),
                  aspect=np.ones(3, np.float32),
                  ppx=rng.uniform(50, 90, 3).astype(np.float32),
                  ppy=rng.uniform(40, 60, 3).astype(np.float32),
                  R=rng.normal(size=(3, 3, 3)).astype(np.float32),
                  t=np.zeros((3, 3), np.float32))
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jpersist.serialize_camera_params(JCameras(**fields), str(tmp_path / "j"))
    persistence.serialize_camera_params(cameras_from_numpy(
        JCameras(**fields), device="cpu"), str(tmp_path / "p"))
    persistence.serialize_indices([0, 2, 5], str(tmp_path / "p"))
    assert (tmp_path / "p" / "cams.data").read_text() == \
        (tmp_path / "j" / "cams.data").read_text()
    assert (tmp_path / "p" / "indices.data").read_text() == "0\n2\n5\n"


def test_features_from_reference_state():
    g = np.random.default_rng(1).uniform(0, 255, (90, 120)).astype(
        np.float32)
    ref = orb_detect_and_describe(jnp.asarray(g), n_features=50)
    f = features_from_numpy(ref, device="cpu")
    assert f.desc.dtype == torch.int32 and f.valid.dtype == torch.bool
    np.testing.assert_array_equal(n(f.desc).view(np.uint32),
                                  np.asarray(ref.desc))
    np.testing.assert_array_equal(n(f.xy), np.asarray(ref.xy))
    assert int(f.count()) == int(ref.count())
    assert torch.equal(t(np.asarray(ref.valid)), f.valid)
