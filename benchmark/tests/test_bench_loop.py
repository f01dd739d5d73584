"""The rest of a run on the CPU at a tiny size: the closed loop, the
judgement and the result line, sound and with the stitch broken
underneath.  The look for a card is `run.main`'s and is skipped here."""

import io
import json
import os
import tempfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import faults, loop, run

TINY = {"ring8": dict(hw=[240, 320], n_images=4)}


def _cell(name="ring8.stitch", **capture):
    cell = run.Cell(name)
    cell.config["capture"].update(TINY[cell.entry["config"]], **capture)
    return cell


def _run(cell, stitch):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.run_cell(cell, 3000000019, 0.0, False, run.Device("cpu"),
                          stitch, min_stitches=2)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _stitch(*args, **kw):
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    return stitch(*args, **kw)


@pytest.mark.parametrize("name", ["ring8.stitch", "ring8.resume"])
def test_sound_run_is_correct(name):
    cell = _cell(name)
    result = _run(cell, _stitch)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] == 2 and result["failed"] == 0
    # Each end-to-end metric the cell lists, and no other.
    assert set(result["metrics"]) == {m["name"] for m in
                                      cell.metrics("end_to_end")}
    assert {"setup_s", "peak_device_gib"} <= set(result["metrics"])
    assert list(result)[-1] == "checks"
    if "stitch_mp_per_s" in result["metrics"]:
        assert result["metrics"]["stitch_mp_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["shifted", "turned", "half", "stale",
                                   "exposure", "seams"])
def test_broken_stitch_is_not_correct(fault):
    result = _run(_cell(), faults.FAULTS[fault](_stitch))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["half", "exposure", "seams"])
def test_broken_resume_is_not_correct(fault):
    result = _run(_cell("ring8.resume"), faults.FAULTS[fault](_stitch))
    assert result["correct"] is False, result["checks"]


def test_judge_control_reads_worse():
    """The control (the reference in bfloat16 in the program's place) reads
    worse than the program on every number it moves."""
    cell = _cell()
    with tempfile.TemporaryDirectory() as wd:
        sets = loop.prepare(cell.config, cell.params, 5, wd, "cpu")
        window = loop.run_window(_stitch, sets, 0.0, os.path.join(
            wd, "r.jpg"), 5, "cpu", min_stitches=2)
        program = loop.judge(window, sets, cell.config)
        control = loop.judge(window, sets, cell.config, control=True)
    assert control["pano_mae"] > 3 * program["pano_mae"]
    assert control["mask_xor_pct"] > program["mask_xor_pct"]


def test_seam_overlap_of_hand_made_masks():
    """Two 4 x 6 masks at corners 4 px apart: disjoint seams read 0, the
    warped masks left as they are read the shared 2 columns of 10."""
    from benchmark import reference
    a, b = np.ones((4, 6), np.uint8), np.ones((4, 6), np.uint8)
    corners = [(0, 0), (4, 0)]
    assert reference.seam_overlap_pct(corners, [a, b]) == 20.0
    a[:, 5:] = 0
    b[:, :1] = 0
    assert reference.seam_overlap_pct(corners, [a, b]) == 0.0
