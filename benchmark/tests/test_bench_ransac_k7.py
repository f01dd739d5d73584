"""`ransac_k7_pairs` on hand-built traces: the mean of the window's
`ransac.k7_pairs` counters, and nothing where no stitch counted it (a
program without K7, or a cell that bypasses matching)."""

import pytest

from benchmark import run, spans
from image_stitching_tpu_torch.core import logging as log


def _trace(trace_id, pairs=None, profiled=False):
    counters = {} if pairs is None else {"ransac.k7_pairs": pairs}
    t = log.Trace(trace_id, profiled, counters=counters)
    t.spans.append(log.Span("stitch", -1, 0, 1_000_000, trace_id))
    return t


def _read(traces, monkeypatch, cell="rig37.stitch", walls=2):
    monkeypatch.setattr(log, "recent_traces", lambda: list(traces))
    return run.Cell(cell).reader("ransac_k7_pairs")(
        run.Context(walls=[1.0] * walls, stage_means={}))


@pytest.mark.parametrize("window, want", [
    ([666, 666], 666.0),
    ([28, None], 14.0),
    ([None, None], None),
])
def test_reads_the_window_counter(monkeypatch, window, want):
    """The warm-up and the profiled stitch after the window are left out;
    a stitch that did not count reads 0 beside one that did."""
    traces = ([_trace(1, 999)] + [_trace(2 + i, p)
                                  for i, p in enumerate(window)]
              + [_trace(9, 5, profiled=True)])
    got = _read(traces, monkeypatch)
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_read_without_the_programs_traces(monkeypatch):
    monkeypatch.setattr(spans, "_log", lambda: None)
    assert run.Cell("ring8.stitch").reader("ransac_k7_pairs")(
        run.Context(walls=[1.0], stage_means={})) is None


def test_listed_for_the_stitch_cells_alone():
    names = {c: {m["name"] for m in run.Cell(c).metrics("per_layer")}
             for c in ("ring8.stitch", "rig37.stitch", "ring8.resume")}
    assert "ransac_k7_pairs" in names["ring8.stitch"]
    assert "ransac_k7_pairs" in names["rig37.stitch"]
    assert "ransac_k7_pairs" not in names["ring8.resume"]
