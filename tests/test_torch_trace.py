"""The port's span tree (`core/logging.py`): every stitch returns a trace
whose root covers its stages, whose stages are `stage_times`, whose spans
nest, whose counters count what was uploaded and how often the LM loop
stepped, and whose clock is the profiler's.

The captures are test_torch_e2e.py's (3 images of 160x224, ring 55 deg
FOV, 0.55 overlap).  Four stitches on the CPU: fast ingest (`fast`), the
legacy decode (`legacy`), the checkpoint resume of the first (`resume`),
and fast ingest again under torch.profiler (`profiled`)."""

import os
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.core import logging as log
from image_stitching_tpu_torch.core.logging import Recorder
from image_stitching_tpu_torch.estimation import bundle_adjust
from image_stitching_tpu_torch.pipeline import stitcher
from image_stitching_tpu_torch.pipeline.stitcher import stitch

HW = (160, 224)
N_IMAGES = 3
SMALL = dict(num_features=400, compose_megapix=-1, seam_megapix=0.02)
ROUTES = ("fast", "legacy", "resume", "profiled")
# The stages before this tree, whose names and coverage stay.
OLD_STAGES = ("Reading images and priors", "Finding features",
              "Pairwise matching", "Bundle adjustment", "Warping images",
              "Compensating exposure", "Finding seams", "Compositing")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("captures")
    images, k, rs = make_ring_captures(n_images=N_IMAGES, hw=HW, fov_deg=55,
                                       overlap_ratio=0.55)
    write_capture_dir(str(d), images, k, rs)
    ckpt = tmp_path_factory.mktemp("ckpt")
    out = str(ckpt / "result.jpg")
    got = {}
    with Recorder(stitcher, "fast_prep") as prep, \
            Recorder(bundle_adjust._Problem, "cost") as cost:
        got["fast"] = stitch(str(d), StitchConfig(
            checkpoint_dir=str(ckpt), **SMALL), output=out, device="cpu")
    got["legacy"] = stitch(str(d), StitchConfig(
        checkpoint_dir=str(tmp_path_factory.mktemp("legacy")),
        fast_ingest=False, **SMALL), output=out, device="cpu")
    got["resume"] = stitch(str(d), StitchConfig(
        checkpoint_dir=str(ckpt), serialize_data=False, **SMALL),
        output=out, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got["profiled"] = stitch(str(d), StitchConfig(
            checkpoint_dir=str(tmp_path_factory.mktemp("profiled")),
            **SMALL), output=out, device="cpu")
    return dict(results=got, prep=prep.calls["fast_prep"],
                cost=cost.calls["cost"], events=prof.events(), dir=str(d))


@pytest.mark.parametrize("route", ROUTES)
def test_spans_nest_in_their_parents(runs, route):
    trace = runs["results"][route].trace
    assert trace.spans[0].name == "stitch" and trace.spans[0].parent == -1
    for i, s in enumerate(trace.spans):
        assert s.trace_id == trace.trace_id
        assert s.end_ns >= s.start_ns > 0, s
        if i == 0:
            continue
        assert 0 <= s.parent < i, s
        p = trace.spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)


@pytest.mark.parametrize("route", ROUTES)
def test_stage_spans_are_the_stage_times(runs, route):
    res = runs["results"][route]
    stages = {}
    for s in res.trace.stages():
        stages[s.name] = stages.get(s.name, 0.0) + s.seconds
    assert stages.keys() == res.stage_times.keys()
    for name, secs in stages.items():
        assert res.stage_times[name] == pytest.approx(secs, rel=1e-12)
    # Neither the root nor a child span is a stage.
    inner = {s.name for s in res.trace.spans[1:] if s.parent != 0}
    assert "stitch" not in res.stage_times
    assert not inner & res.stage_times.keys()


@pytest.mark.parametrize("route", ROUTES)
def test_root_covers_every_stage_with_one_fence_each(runs, route):
    trace = runs["results"][route].trace
    root = trace.root
    for i, s in enumerate(trace.spans):
        if s.parent != 0:
            continue
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
        kids = trace.children(i)
        assert [c.name for c in kids].count("fence") == 1
        assert kids[-1].name == "fence", s.name
    stages = trace.stages()
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))


def test_stages_of_each_route(runs):
    res = runs["results"]
    full = list(OLD_STAGES)
    full[3:3] = ["Selecting images"]
    full[5:5] = ["Saving checkpoint", "Wave correction"]
    assert list(res["fast"].stage_times) == full + ["Writing result"]
    assert list(res["legacy"].stage_times) == full + ["Writing result"]
    assert list(res["resume"].stage_times) == [
        "Reading images and priors", "Finding features",
        "Reading checkpoint", "Wave correction"] + list(OLD_STAGES[4:]) + [
        "Writing result"]


def test_upload_bytes_are_the_uploaded_tensors(runs):
    (args, _, _), = runs["prep"]
    gray, rgb = args[1], args[2]
    want = rgb.nbytes + (0 if gray is None else gray.nbytes)
    assert runs["results"]["fast"].trace.counters[
        "ingest.upload_bytes"] == want
    # The legacy route uploads each decoded RGB capture.
    assert runs["results"]["legacy"].trace.counters[
        "ingest.upload_bytes"] == N_IMAGES * HW[0] * HW[1] * 3


def test_ba_iterations_are_the_cost_calls(runs):
    trace = runs["results"]["fast"].trace
    steps = trace.counters["ba.iterations"]
    assert steps == len(runs["cost"]) > 0
    assert steps == sum(s.name == "lm iteration" for s in trace.spans)
    assert "ba.iterations" not in runs["results"]["resume"].trace.counters


def test_child_spans_name_the_work(runs):
    trace = runs["results"]["fast"].trace
    names = [s.name for s in trace.spans]
    by_name = {}
    for i, s in enumerate(trace.spans):
        by_name.setdefault(s.name, []).append((i, s))
    orb = by_name["orb image"]
    assert len(orb) == N_IMAGES
    for i, _ in orb:
        kids = [c.name for c in trace.children(i)]
        assert kids[-1] == "describe (K1)" and kids.count("describe (K1)") == 1
        assert set(kids[:-1]) == {"orb level"}
    (_, k4), = by_name["K4"]
    assert k4.attrs == dict(n=N_IMAGES, k=400, w=8, pairs=3)
    blocks = by_name["ransac block"]
    assert blocks and all(trace.spans[s.parent].name == "Pairwise matching"
                          and s.attrs is None for _, s in blocks)
    waits = by_name["decode wait"]
    assert all(trace.spans[s.parent].name == "upload" for _, s in waits)
    assert sorted(s.attrs["item"] for _, s in waits) == list(range(
        len(waits)))
    for name in ("priors", "probe sizes", "start decode", "fast_prep",
                 "matches to host", "pack", "warp_stack", "masks to host",
                 "K5"):
        assert name in names, name


def test_profiler_ranges_share_the_span_clock(runs):
    """Each span is a profiler range of its name, and the range's start
    lies a fixed offset from the span's: within 1 ms of the median offset
    for 95% of the spans."""
    trace = runs["results"]["profiled"].trace
    assert trace.profiled
    assert not runs["results"]["fast"].trace.profiled
    events = {}
    for e in runs["events"]:
        if e.device_type == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name, []).append(e.time_range.start)
    offsets = []
    names = {s.name for s in trace.spans}
    for name in names:
        mine = [s.start_ns for s in trace.spans if s.name == name]
        theirs = sorted(events.get(name, []))
        assert len(theirs) == len(mine), name
        offsets += [1e3 * us - ns for us, ns in zip(theirs, mine)]
    mid = statistics.median(offsets)
    close = np.mean([abs(o - mid) < 1e6 for o in offsets])
    assert close >= 0.95, close


def test_a_stitch_that_raises_leaves_no_trace(runs, tmp_path):
    kept = log.recent_traces()
    one = os.path.join(runs["dir"], sorted(os.listdir(runs["dir"]))[0])
    with pytest.raises(ValueError):
        stitch([one], StitchConfig(checkpoint_dir=str(tmp_path), **SMALL),
               output="", device="cpu")
    assert [t.trace_id for t in log.recent_traces()] == [
        t.trace_id for t in kept]


def test_recent_traces_keep_a_bounded_tail_and_the_first():
    with log.trace_stitch():
        pass
    first = log.first_trace()
    assert first is not None
    for _ in range(log.RECENT_TRACES + 5):
        with log.trace_stitch() as last:
            with log.span("work", n=1):
                log.count("things", 2)
    kept = log.recent_traces()
    assert len(kept) == log.RECENT_TRACES and kept[-1] is last
    assert log.first_trace() is first and first not in kept
    assert last.counters == {"things": 2}
    assert [s.name for s in last.spans] == ["stitch", "work"]
    assert last.spans[1].attrs == {"n": 1}


def test_spans_outside_a_trace_are_ranges_alone():
    before = log.recent_traces()[-1:]
    with log.span("alone") as s:
        log.count("nowhere")
    assert s.seconds >= 0.0
    assert log.recent_traces()[-1:] == before
