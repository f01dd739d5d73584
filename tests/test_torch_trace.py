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

from _torch_port import Recorder
from image_stitching_tpu.data.synth import (make_ring_captures,
                                            write_capture_dir)
from image_stitching_tpu_torch.config import StitchConfig
from image_stitching_tpu_torch.core import logging as log
from image_stitching_tpu_torch.estimation import bundle_adjust
from image_stitching_tpu_torch.pipeline import ingest, stitcher
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


@pytest.mark.parametrize("route", ROUTES)
def test_decode_threads_are_the_width(runs, route):
    """Fast ingest counts `ingest.decode_threads` once a stitch with the
    width `decode_width` gives on this host (one 4:2:0 item a view) and
    puts it on `start decode` as `threads`; the legacy decode has
    neither."""
    trace = runs["results"][route].trace
    starts = [s for s in trace.spans if s.name == "start decode"]
    if route == "legacy":
        assert not starts
        assert "ingest.decode_threads" not in trace.counters
        return
    width = ingest.decode_width(N_IMAGES, *ingest._cpu_limits())
    assert trace.counters["ingest.decode_threads"] == width
    (start,) = starts
    assert start.attrs == {"threads": width}


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


def _spans_under(trace, stage):
    """The spans whose parent is the stage called `stage`, in order."""
    (index,) = [i for i, s in enumerate(trace.spans)
                if s.parent == 0 and s.name == stage]
    return trace.children(index)


def _host_ints(attrs):
    return attrs is None or all(type(v) is int for v in attrs.values())


def test_seam_and_exposure_spans_sit_under_their_stages(runs):
    """On each route the seam finder's and the gain fit's spans sit under
    their stages, with host-integer attributes, and the `dp batch`
    spans' task counts add up to the `seams.tasks` counter."""
    for route in ROUTES:
        trace = runs["results"][route].trace
        seams_kids = [s.name for s in _spans_under(trace, "Finding seams")]
        assert seams_kids[0] == "seam overlaps" and seams_kids[-1] == "fence"
        assert seams_kids[-2] == "seam apply", seams_kids
        assert set(seams_kids[1:-2]) == {"dp batch"}, seams_kids
        expo = _spans_under(trace, "Compensating exposure")
        assert [s.name for s in expo] == ["exposure stats", "gain solve",
                                          "fence"]
        assert expo[1].attrs["unknowns"] > 0
        for s in trace.spans:
            assert _host_ints(s.attrs), s
        batches = [s for s in trace.spans if s.name == "dp batch"]
        assert all(set(s.attrs) == {"n", "bh", "bw"} for s in batches)
        assert trace.counters["seams.tasks"] == sum(
            s.attrs["n"] for s in batches) > 0


def _seam_scene():
    """Three 40 x 64 random images at staggered corners: every pair
    overlaps, the first and last in a band that all three share."""
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 255, (3, 40, 64, 3)).astype(np.float32)
    masks = [np.full((40, 64), 255, np.uint8) for _ in range(3)]
    masks[1][:6, :10] = 0
    return imgs, masks, [(0, 0), (24, 4), (44, 8)]


@pytest.mark.parametrize("strict", [False, True])
def test_seam_spans_count_the_dp_tasks(strict):
    """Both branches of `_find_seams_dp`: `seams.tasks` is the number of
    DP tasks `_dp_pair_tasks` cut, one `dp batch` span a shape bucket of
    each `_run_dp_tasks` call holding that bucket's task count, and the
    pass over the pairs in `seam overlaps` (one a pair when strict)."""
    from image_stitching_tpu_torch.ops import seams
    imgs, masks, corners = _seam_scene()
    with Recorder(seams, "_dp_pair_tasks", "_run_dp_tasks") as rec, \
            log.trace_stitch() as trace:
        with log.stage_timer("Finding seams"):
            seams.find_seams(corners, masks, "dp_color",
                             images_dev=torch.as_tensor(imgs),
                             strict=strict)
    tasks = [t for _, _, out in rec.calls["_dp_pair_tasks"] for t in out]
    assert trace.counters["seams.tasks"] == len(tasks) > 0
    buckets = []
    for (run_tasks, *_), _, _ in rec.calls["_run_dp_tasks"]:
        shapes = {}
        for t in run_tasks:
            h, w = t["vc"].shape
            key = (seams.bucket_dim(h), seams.bucket_dim(w))
            shapes[key] = shapes.get(key, 0) + 1
        buckets += sorted((n, bh, bw) for (bh, bw), n in shapes.items())
    kids = _spans_under(trace, "Finding seams")
    got = [(s.attrs["n"], s.attrs["bh"], s.attrs["bw"]) for s in kids
           if s.name == "dp batch"]
    assert sorted(got) == sorted(buckets)
    names = [s.name for s in kids]
    pairs = 3 if strict else 1
    assert names.count("seam overlaps") == pairs
    assert names.count("seam apply") == len(rec.calls["_run_dp_tasks"])
    assert set(names) == {"seam overlaps", "dp batch", "seam apply",
                          "fence"}
    assert all(_host_ints(s.attrs) for s in kids)


@pytest.mark.parametrize("route", ["feed", "feed_device"])
def test_exposure_spans_of_both_feeds(route):
    """`feed` and `feed_device` each trace `exposure stats` then `gain
    solve`, whose `unknowns` is the block system's size: every view's
    grid of 64-px blocks."""
    from image_stitching_tpu_torch.ops import exposure
    imgs, masks, corners = _seam_scene()
    sizes = [(m.shape[1], m.shape[0]) for m in masks]
    with log.trace_stitch() as trace:
        with log.stage_timer("Compensating exposure"):
            if route == "feed":
                comp = exposure.feed(corners, list(imgs), masks)
            else:
                comp = exposure.feed_device(
                    corners, sizes, torch.as_tensor(imgs.astype(np.uint8)),
                    torch.as_tensor(np.stack(masks)))
    kids = _spans_under(trace, "Compensating exposure")
    assert [s.name for s in kids] == ["exposure stats", "gain solve",
                                      "fence"]
    assert kids[0].attrs is None
    assert kids[1].attrs == {"unknowns": int(comp.grid_sizes.prod(1).sum())}
