"""The span readers (`benchmark/spans.py` and the metrics that read the
program's traces) on hand-built traces: the window's stitches are chosen,
the warm-up and the profiled stitches are left out."""

import pytest

from benchmark import run, spans
from image_stitching_tpu_torch.core import logging as log

MS = 1_000_000


def _trace(trace_id, stages, counters=None, profiled=False, root=(0, 100)):
    """A trace whose root spans `root` (ms) over the top-level `stages`,
    each (name, start, end, [(child, start, end)]) in ms."""
    t = log.Trace(trace_id, profiled, counters=dict(counters or {}))
    t.spans.append(log.Span("stitch", -1, root[0] * MS, root[1] * MS,
                            trace_id))
    for name, a, b, children in stages:
        index = len(t.spans)
        t.spans.append(log.Span(name, 0, a * MS, b * MS, trace_id))
        for child, ca, cb in children:
            t.spans.append(log.Span(child, index, ca * MS, cb * MS,
                                    trace_id))
    return t


def _stitch(trace_id, scale=1, profiled=False):
    """A stitch whose stages leave 10 of its 100 ms untraced; `scale`
    multiplies its decode waits and counters."""
    return _trace(trace_id, [
        ("Reading images and priors", 0, 40,
         [("decode wait", 5, 5 + 4 * scale), ("fence", 38, 40)]),
        ("Finding features", 45, 80,
         [("orb level", 46, 50), ("orb level", 50, 52), ("fence", 70, 80)]),
        ("Writing result", 85, 100, [("fence", 99, 100)]),
    ], counters={"ingest.upload_bytes": scale * 2 ** 20,
                 "ba.iterations": 10 * scale}, profiled=profiled)


@pytest.fixture
def kept(monkeypatch):
    """The program keeps a warm-up, three window stitches (scales 1-3) and
    two profiled stitches (scale 100), oldest first."""
    traces = ([_stitch(1, scale=50)] + [_stitch(2 + i, scale=1 + i)
                                        for i in range(3)]
              + [_stitch(5 + i, scale=100, profiled=True)
                 for i in range(2)])
    monkeypatch.setattr(log, "recent_traces", lambda: list(traces))
    monkeypatch.setattr(log, "first_trace", lambda: traces[0])
    return traces


def _read(metric, walls=3):
    return run.Cell("ring8.stitch").reader(metric)(
        run.Context(walls=[1.0] * walls, stage_means={}))


def test_window_is_the_last_quiet_traces(kept):
    got = spans.window(run.Context(walls=[1.0] * 3))
    assert [t.trace_id for t in got] == [2, 3, 4]
    # The walls say how many: four reach back to the warm-up, five are
    # more than were kept.
    assert [t.trace_id for t in spans.window(
        run.Context(walls=[1.0] * 4))] == [1, 2, 3, 4]
    assert spans.window(run.Context(walls=[1.0] * 5)) is None
    assert spans.window(run.Context(walls=[])) is None


@pytest.mark.parametrize("metric, want", [
    # Waits of 4, 8 and 12 ms.
    ("decode_wait_s", 0.008),
    ("orb_detect_s", 0.006),
    ("ransac_s", 0.0),
    # 1, 2 and 3 MiB.
    ("upload_mib", 2.0),
    ("ba_iterations", 20.0),
    # 100 ms less stages of 40 + 35 + 15.
    ("untraced_pct", 10.0),
    # Fences of 2 + 10 + 1 over 90 ms of stages.
    ("fence_wait_pct", 100.0 * 13 / 90),
    # The warm-up's root, not the window's.
    ("warmup_stitch_s", 0.1),
])
def test_reader_on_hand_built_traces(kept, metric, want):
    assert _read(metric) == pytest.approx(want)
    assert _read(metric + ".resume") == pytest.approx(want)


def test_warmup_reads_the_first_trace(kept, monkeypatch):
    slow = _trace(0, [], root=(0, 7000))
    monkeypatch.setattr(log, "first_trace", lambda: slow)
    assert _read("warmup_stitch_s") == pytest.approx(7.0)


def test_untraced_counts_overlap_once(monkeypatch):
    """Overlapping stages and a stage past the root are counted once and
    clipped: 20-60 and 40-80 cover 60 of 100 ms; 90-120 adds 10."""
    t = _trace(1, [("A", 20, 60, []), ("B", 40, 80, []),
                   ("C", 90, 120, [])])
    monkeypatch.setattr(log, "recent_traces", lambda: [t])
    assert _read("untraced_pct", walls=1) == pytest.approx(30.0)


def test_nothing_read_without_the_programs_traces(monkeypatch):
    """A program that keeps no traces reads as nothing, without raising."""
    monkeypatch.setattr(spans, "_log", lambda: None)
    for metric in ("decode_wait_s", "orb_detect_s", "ransac_s",
                   "upload_mib", "ba_iterations", "untraced_pct",
                   "fence_wait_pct", "warmup_stitch_s"):
        assert _read(metric) is None, metric


def test_write_s_reads_its_stage():
    cell = run.Cell("ring8.resume")
    ctx = run.Context(stage_means={"Writing result": 0.125})
    assert cell.reader("write_s.resume")(ctx) == 0.125
    assert cell.reader("write_s")(run.Context(stage_means={})) is None
