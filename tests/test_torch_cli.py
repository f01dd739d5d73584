"""Port parity: the command line (`image_stitching_tpu_torch/cli.py`)
against `image_stitching_tpu/cli.py`, and what its main() writes."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from image_stitching_tpu import cli as jcli
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu_torch import cli
from image_stitching_tpu_torch.core.persistence import (
    deserialize_camera_params, deserialize_indices)
from image_stitching_tpu_torch.estimation.wave_correct import wave_correct
from image_stitching_tpu_torch.pipeline.stitcher import compose_inputs, stitch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [
    [],
    ["--work-megapix", "1.9", "--num-features", "1500"],
    ["--expos-comp", "channels_blocks", "--seam", "dp_colorgrad",
     "--blend", "feather", "--blend-strength", "3"],
    ["--features", "sift", "--wave-correct", "no", "--ba", "ray",
     "--ba-refine-mask", "x____", "--matcher", "affine"],
    ["--timelapse", "--timelapse-type", "as_is", "--range-width", "3",
     "--no-find-features", "--crop", "--no-sensor-priors",
     "--infill-dropped", "--checkpoint-npz", "--save-graph", "g.dot",
     "--seed", "7", "--result", "out.jpg", "--checkpoint-dir", "ck",
     "--conf-thresh", "0.5", "--match-conf", "0.4", "--orb-pattern", "cv",
     "--expos-comp-nr-feeds", "2", "--expos-comp-nr-filtering", "1",
     "--expos-comp-block-size", "32", "--compose-megapix", "-1",
     "--seam-megapix", "0.2", "--warp", "cylindrical",
     "--estimator", "affine", "--profile-dir", "prof"],
]


def _fields(cfg):
    return {f.name: (getattr(cfg, f.name).value
                     if hasattr(getattr(cfg, f.name), "value")
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("argv", range(len(ARGVS)))
def test_config_from_args_matches_reference(argv):
    """The same StitchConfig, field by field, for the same flags; the zero
    flag run is StitchConfig() in both; --device is the port's only extra
    flag."""
    args = ["caps"] + ARGVS[argv]
    got = cli.config_from_args(cli.build_parser().parse_args(
        args + ["--device", "cpu"]))
    want = jcli.config_from_args(jcli.build_parser().parse_args(args))
    assert _fields(got) == _fields(want)
    if argv == 0:
        assert got == type(got)()
    assert cli.build_parser().parse_args(args).device == "cuda"
    jflags = {a.dest for a in jcli.build_parser()._actions}
    assert {a.dest for a in cli.build_parser()._actions} - jflags == \
        {"device"}


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_captures")
    images, k, rs = make_ring_captures(n_images=3, hw=(160, 224), fov_deg=55,
                                       overlap_ratio=0.55)
    write_capture_dir(str(d), images, k, rs)
    return str(d)


SMALL = ["--num-features", "400", "--compose-megapix", "-1",
         "--seam-megapix", "0.02"]


def test_main_writes_the_stitch_panorama(captures, tmp_path, capsys):
    """main() with the port's flags on the CPU exits 0, prints the stage
    lines, and writes the JPEG stitch() writes for the same config, byte
    for byte."""
    out = str(tmp_path / "cli.jpg")
    argv = [captures, "--device", "cpu", "--result", out,
            "--checkpoint-dir", str(tmp_path)] + SMALL
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "Reading images and priors, time:" in printed
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert cfg.fast_ingest and cfg.expos_comp_type.value == "gain_blocks"
    ref = str(tmp_path / "stitch.jpg")
    res = stitch(captures, cfg, output=ref, device="cpu")
    h, w = res.panorama.shape[:2]
    assert f"wrote {out} ({w}x{h})" in printed
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with Image.open(out) as im:
        assert im.size == (w, h)
    assert os.path.exists(tmp_path / "cams.data")


def _canvas_bounds(run_dir, hw, cfg):
    """Float (x0, y0, x1, y1) of the compose canvas that the cameras a run
    wrote (`cams.data`, `indices.data`) give, wave-corrected as the stitch
    then does, at SMALL's compose scale 1: each kept view's border mapped
    forward (spherical), the union.  The panorama's size is int(x1) -
    int(x0) + 1 by int(y1) - int(y0) + 1 of the views' own bounds
    (`Warper.detect_result_roi`)."""
    cams = deserialize_camera_params(str(run_dir), device="cpu")
    cams = dataclasses.replace(cams, R=wave_correct(cams.R,
                                                    cfg.wave_correct))
    n_kept = len(deserialize_indices(str(run_dir)))
    comp = compose_inputs(cams, [hw] * n_kept, 1.0, -1.0, "spherical")
    h, w = hw
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    border = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], -1),
        np.stack([xs, np.full_like(xs, h - 1)], -1),
        np.stack([np.zeros_like(ys), ys], -1),
        np.stack([np.full_like(ys, w - 1), ys], -1)])
    lo, hi = [], []
    for k, r in zip(comp.ks, comp.rs):
        u, v = comp.warper.warp_point(border, k, r)
        lo.append((u.min(), v.min()))
        hi.append((u.max(), v.max()))
    return np.concatenate([np.min(lo, 0), np.max(hi, 0)])


@pytest.mark.parametrize("flags,option", [
    (["--features", "sift"], "features_type"),
    (["--features", "akaze"], "features_type"),
    (["--features", "surf"], "features_type")])
def test_refused_option_exits_nonzero(captures, tmp_path, capsys, flags,
                                      option):
    """The detectors other than ORB, which the port once refused, exit as
    the reference's CLI does on the same captures (fast ingest): the same
    code; on 1 both print the reference's message and write nothing.  On
    these 160x224 captures SIFT keeps too few keypoints and exits 1 with
    "Need more images".  On 0 both keep the same views and write a
    panorama; its size truncates the canvas's float bounds, which sit
    within 0.13 px of an integer here (AKAZE's bottom edge at 413.87,
    SURF's top at 260.81), and the reference's own bounds move more than
    that between hosts (its AKAZE and SURF heights each moved by a pixel
    in one run), so the port is held to the reference on the bounds,
    within a pixel, and the sizes within the two pixels that a pixel's
    move of both edges can make."""
    runs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.jpg")
        run_dir = tmp_path / name
        run_dir.mkdir()
        code = main([captures, "--result", out, "--checkpoint-dir",
                     str(run_dir)] + SMALL + flags + extra)
        printed = capsys.readouterr()
        runs[name] = (code, out, printed.err, run_dir)
    (code_j, out_j, err_j, dir_j), (code_t, out_t, err_t, dir_t) = \
        runs["jax"], runs["torch"]
    assert code_t == code_j, (flags, code_j, err_j[-500:], err_t[-500:])
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [captures] + flags))
    assert getattr(cfg, option) == flags[1]
    if code_j == 0:
        assert deserialize_indices(str(dir_t)) == \
            deserialize_indices(str(dir_j))
        bounds_j = _canvas_bounds(dir_j, (160, 224), cfg)
        bounds_t = _canvas_bounds(dir_t, (160, 224), cfg)
        assert np.abs(bounds_t - bounds_j).max() <= 1.0, (bounds_j,
                                                          bounds_t)
        with Image.open(out_j) as a, Image.open(out_t) as b:
            assert a.size[0] > 224 and b.size[0] > 224
            assert all(abs(x - y) <= 2 for x, y in zip(a.size, b.size)), \
                (a.size, b.size, bounds_j, bounds_t)
    else:
        assert code_j == 1
        msg = err_j.strip().splitlines()[-1]
        assert "Need more images" in msg and msg in err_t
        assert not os.path.exists(out_j) and not os.path.exists(out_t)
    assert (flags[1], code_t) != ("sift", 0)


def test_bad_flag_exits_two():
    with pytest.raises(SystemExit) as e:
        cli.main(["caps", "--blend", "nope"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        jcli.main(["caps", "--blend", "nope"])
    assert e.value.code == 2


def test_python_dash_m_entry_point(captures):
    """`python -m image_stitching_tpu_torch` runs the CLI's main: --help
    exits 0 with the port's usage, a rejected value exits 2 naming the
    flag."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "image_stitching_tpu_torch"]
    out = subprocess.run(cmd + ["--help"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("usage: image_stitching_tpu_torch")
    assert "--device" in out.stdout
    out = subprocess.run(cmd + [captures, "--device", "cpu", "--features",
                                "nope"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and "--features" in out.stderr


def test_graph_profile_and_resume_flags(captures, tmp_path, capsys):
    """--save-graph and --profile-dir exit 0 and write the DOT file (an
    edge per kept adjacent pair) and a trace; --no-find-features then
    resumes from the checkpoint that run wrote, exit 0, without the
    matching and BA stages."""
    dot, prof = str(tmp_path / "g.dot"), str(tmp_path / "prof")
    base = [captures, "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    assert cli.main(base + SMALL + ["--result", str(tmp_path / "a.jpg"),
                                    "--save-graph", dot,
                                    "--profile-dir", prof]) == 0
    text = open(dot).read()
    assert text.startswith("graph matches_graph {")
    assert '"0.jpg" -- "1.jpg"' in text and '"1.jpg" -- "2.jpg"' in text
    assert os.path.getsize(os.path.join(prof, "stitch_trace.json")) > 0
    capsys.readouterr()
    assert cli.main(base + SMALL + ["--result", str(tmp_path / "b.jpg"),
                                    "--no-find-features"]) == 0
    printed = capsys.readouterr().out
    assert "Pairwise matching" not in printed
    assert "Bundle adjustment" not in printed
    assert os.path.getsize(tmp_path / "b.jpg") > 0


@pytest.mark.parametrize("flags", [
    ["--matcher", "affine", "--estimator", "affine", "--ba", "affine",
     "--warp", "affine", "--wave-correct", "no"],
    ["--ba", "ray"], ["--ba", "no"], ["--no-sensor-priors"]])
def test_registration_flags_stitch(captures, tmp_path, capsys, flags):
    """The registration flags reach a stitch: OpenCV stitching_detailed's
    flag set for scans (affine matcher, estimator, bundle adjustment and
    warp, no wave correction), the ray and no bundle adjustment costs, and
    seeding without the EXIF priors: exit 0, the checkpoint of at least
    two kept images (on these 160x224 captures the affine matcher keeps
    two), a panorama wider than one capture."""
    out = str(tmp_path / "r.jpg")
    argv = [captures, "--device", "cpu", "--result", out, "--checkpoint-dir",
            str(tmp_path)] + SMALL + flags
    assert cli.main(argv) == 0
    assert "Bundle adjustment, time:" in capsys.readouterr().out
    with open(tmp_path / "indices.data") as f:
        assert len(f.read().split()) >= 2
    with Image.open(out) as im:
        assert im.size[0] > 224


def test_crop_flag_stitches(captures, tmp_path, capsys):
    """--crop exits 0 and writes the cropped panorama, smaller than the
    canvas of the same stitch without it, with the size it prints."""
    base = [captures, "--device", "cpu", "--checkpoint-dir",
            str(tmp_path)] + SMALL
    full, cut = str(tmp_path / "full.jpg"), str(tmp_path / "cut.jpg")
    assert cli.main(base + ["--result", full]) == 0
    capsys.readouterr()
    assert cli.main(base + ["--result", cut, "--crop"]) == 0
    with Image.open(full) as a, Image.open(cut) as b:
        assert b.size[0] <= a.size[0] and b.size[1] <= a.size[1]
        assert b.size != a.size
        size = b.size
    assert f"wrote {cut} ({size[0]}x{size[1]})" in capsys.readouterr().out


def test_timelapse_flag_writes_frames(captures, tmp_path, capsys,
                                      monkeypatch):
    """--timelapse --timelapse-type as_is exits 0, writes fixed_<name> for
    each capture into the working directory, all the size of the
    canvas, prints the stage lines and, as the reference's CLI, no
    "wrote" line, and writes no result file."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "r.jpg")
    assert cli.main([captures, "--device", "cpu", "--result", out,
                     "--checkpoint-dir", str(tmp_path), "--timelapse",
                     "--timelapse-type", "as_is"] + SMALL) == 0
    printed = capsys.readouterr().out
    assert "Compositing, time:" in printed and "wrote" not in printed
    assert not os.path.exists(out)
    sizes = set()
    for i in range(3):
        with Image.open(tmp_path / f"fixed_{i}.jpg") as im:
            sizes.add(im.size)
    assert len(sizes) == 1 and sizes.pop()[0] > 224
