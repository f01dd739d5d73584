"""The `rig37.stitch` cell: its files resolve, its capture geometry is the
port's rig, a small rig run on the CPU is judged correct and, with the
stitch broken underneath, not correct; and the readers of the seam and
exposure spans it added, on hand-built traces.

The CPU run is the cell at 180x240 views and 1000 features, one capture
set stitched once (no warm-up): the 37 views and the reference's
judgement of the whole sphere are what make it slow."""

import os

import numpy as np
import pytest

from benchmark import faults, loop, run, scene
from image_stitching_tpu_torch.core import logging as log

SEED = 3000000019
TINY_HW = [180, 240]
TINY_FEATURES = 1000
MS = 1_000_000


def _stitch(*args, **kw):
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    return stitch(*args, **kw)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """The cell cut to a CPU size, and its one capture set rendered."""
    cell = run.Cell("rig37.stitch")
    cell.config["capture"]["hw"] = TINY_HW
    cell.config["stitch_config"]["num_features"] = TINY_FEATURES
    wd = str(tmp_path_factory.mktemp("rig37"))
    sets = loop.prepare(cell.config, dict(cell.params, sets=1), SEED, wd,
                        "cpu")
    return cell, sets, wd


def _judged(rig, stitch):
    cell, sets, wd = rig
    window = loop.run_window(stitch, sets, 0.0, os.path.join(wd, "r.jpg"),
                             SEED, "cpu", min_stitches=1)
    numbers = loop.judge(window, sets, cell.config)
    return (loop.verdict(numbers, cell.limits, len(window.records),
                         window.failed), numbers, window)


def test_cell_resolves():
    cell = run.Cell("rig37.stitch")
    assert cell.entry["config"] == "rig37" and cell.chips == 1
    assert cell.params == run.Cell("ring8.stitch").params
    assert cell.config["stitch_config"] == {}
    assert cell.config["capture"]["kind"] == "rig"
    assert cell.config["capture"]["hw"] == [2448, 3264]
    assert cell.config["pair_angle_deg"] == 45.0
    assert cell.config["reduced"] == []
    assert set(cell.limits) == set(run.Cell("ring8.stitch").limits)
    for section in ("end_to_end", "per_layer"):
        for m in cell.metrics(section):
            assert callable(cell.reader(m["name"]))
    names = {m["name"] for m in cell.metrics("per_layer")}
    assert {"seam_overlaps_s", "seam_dp_s", "gain_solve_s", "seam_tasks",
            "k4_roofline_pct", "k5_roofline_pct"} <= names


def test_capture_geometry_is_the_ports_rig():
    """The benchmark's frozen rig table against the port's
    `DEFAULT_RIG.rotation_prior`, as the YXZ Euler rotation."""
    from image_stitching_tpu_torch.core.rig import DEFAULT_RIG
    from image_stitching_tpu_torch.geometry.euler import (
        euler_to_rotation_matrix)
    capture = run.Cell("rig37.stitch").config["capture"]
    k, rs = scene.capture_geometry(capture)
    assert len(rs) == DEFAULT_RIG.total_images == 37
    want = [euler_to_rotation_matrix(
        np.array(DEFAULT_RIG.rotation_prior(i), np.float32), "YXZ")
        for i in range(37)]
    np.testing.assert_allclose(rs, np.stack(want), atol=1e-6)
    assert k[0, 2] == 3264 / 2 and k[1, 2] == 2448 / 2


def test_sound_rig_run_is_correct(rig):
    correct, numbers, window = _judged(rig, _stitch)
    assert correct, numbers
    assert [len(r.kept) for r in window.records] == [37]


@pytest.mark.parametrize("fault", ["half", "seams"])
def test_broken_rig_run_is_not_correct(rig, fault):
    correct, numbers, _ = _judged(rig, faults.FAULTS[fault](_stitch))
    assert not correct, numbers


def _trace(trace_id, children, counters=None, profiled=False):
    """A 100 ms stitch whose one 90 ms stage holds `children`, each (name,
    start, end) in ms."""
    t = log.Trace(trace_id, profiled, counters=dict(counters or {}))
    t.spans.append(log.Span("stitch", -1, 0, 100 * MS, trace_id))
    t.spans.append(log.Span("stage", 0, 0, 90 * MS, trace_id))
    for name, a, b in children:
        t.spans.append(log.Span(name, 1, a * MS, b * MS, trace_id))
    return t


def _read(metric, traces, monkeypatch, walls=2):
    monkeypatch.setattr(log, "recent_traces", lambda: list(traces))
    return run.Cell("rig37.stitch").reader(metric)(
        run.Context(walls=[1.0] * walls, stage_means={}))


@pytest.mark.parametrize("metric, want", [
    # 10 and 20 ms of the pair pass.
    ("seam_overlaps_s", 0.015),
    # Two buckets of 5 + 15 ms, then 30 ms.
    ("seam_dp_s", 0.025),
    ("gain_solve_s", 0.003),
    ("seam_tasks", 7.0),
])
def test_new_readers_on_hand_built_traces(monkeypatch, metric, want):
    """The window's two stitches are read; the profiled one after them
    is left out."""
    traces = [
        _trace(1, [("seam overlaps", 0, 10), ("dp batch", 10, 15),
                   ("dp batch", 15, 30), ("gain solve", 40, 42)],
               {"seams.tasks": 6}),
        _trace(2, [("seam overlaps", 0, 20), ("dp batch", 20, 50),
                   ("gain solve", 50, 54)], {"seams.tasks": 8}),
        _trace(3, [("seam overlaps", 0, 80), ("gain solve", 80, 90)],
               {"seams.tasks": 100}, profiled=True)]
    assert _read(metric, traces, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["seam_overlaps_s", "seam_dp_s",
                                    "gain_solve_s", "seam_tasks"])
def test_new_readers_read_nothing_without_the_spans(monkeypatch, metric):
    """A program without these spans and counter reads as nothing,
    without raising."""
    traces = [_trace(1, [("fence", 80, 90)]), _trace(2, [])]
    assert _read(metric, traces, monkeypatch) is None
    assert _read(metric, [], monkeypatch) is None
