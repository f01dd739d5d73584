"""Where the time goes in the PyTorch port's stitch, on one CUDA GPU.

Run from the repository root:
    python3 -m tools.profile_torch_stitch [--legacy] [--resume] [--rig] \
        [OUT_TXT]

Renders the 8 x 2448x3264 ring DEFAULT_RING (`data/synth.py`, sigma-8
noise), or with --rig the benchmark's `rig37` capture set (the reference's
37-view, 5-ring rig at 2448x3264, `benchmark/configs/rig37.json`,
rendered on the card by `benchmark/scene.py` from seed 7), runs stitch()
with the reference defaults, `StitchConfig()` (fast
ingest; with --legacy the legacy decode, fast_ingest=False; with --resume
the stitches after a first full one resume from its checkpoint,
serialize_data=False), once to warm up and three times timed, then
once under torch.profiler (CPU + CUDA activities).  Prints the stage
times; from the program's spans (`StitchResult.trace`,
`core/logging.py`) each top-level stage's self time (its span less its
children) with its heaviest children, the spans a stitch, the untraced
share of the root, the counters, each span under the exposure and seam
stages of the last timed stitch with its attributes, and the warm-up's
stages; the device-busy share of the wall time, per stage its kernel
launches and device-busy time, the device's idle gaps named by the
innermost span the host was in as each began (the 10 longest, and the
10 spans with the most idle time), each hand kernel's launches and device
time (with each launch's, in launch order), and the ops by total device
time; with OUT_TXT, the 40-row table is also written there.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import torch

from benchmark import spans as trace_spans
from benchmark.yardstick import busy_seconds, device_spans, merged


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _stage_lines(events, spans, stage_names):
    """Per stage (the `stage_timer` ranges): wall, kernel launches made by
    the host inside it, and device-busy time inside it."""
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.name in stage_names}
    launches = [e.time_range.start for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and "LaunchKernel" in e.name]
    out = []
    for name, (lo, hi) in ranges.items():
        n = sum(1 for t in launches if lo <= t <= hi)
        busy = busy_seconds(spans, lo, hi) * 1e3
        wall = (hi - lo) / 1e3
        out.append(f"stage {name}: wall {wall:.3f} ms, {n} kernel launches, "
                   f"device busy {busy:.3f} ms "
                   f"({100 * busy / max(wall, 1e-9):.2f}%)")
    return out


def _self_s(trace, index: int) -> float:
    s = trace.spans[index]
    return (s.end_ns - s.start_ns - trace_spans.union_ns(
        trace.children(index), s.start_ns, s.end_ns)) / 1e9


def _span_lines(traces):
    """Per top-level stage, the mean a stitch of its span and self time,
    and its children's seconds by name, heaviest first ("child >
    grandchild" one level down), each with the first one's attributes."""
    n = len(traces)
    rows = collections.OrderedDict()
    for t in traces:
        for i, s in enumerate(t.spans):
            if s.parent != 0:
                continue
            row = rows.setdefault(s.name, [0.0, 0.0, {}, {}])
            row[0] += s.seconds / n
            row[1] += _self_s(t, i) / n
            for j, c in enumerate(t.spans):
                if c.parent != i:
                    continue
                for g in [c] + t.children(j):
                    key = c.name if g is c else f"{c.name} > {g.name}"
                    row[2][key] = row[2].get(key, 0.0) + g.seconds / n
                    row[3].setdefault(key, g.attrs)
    out = []
    for name, (span_s, self_s, kids, attrs) in rows.items():
        heavy = sorted(kids.items(), key=lambda kv: -kv[1])[:8]
        out.append(f"span {name}: {span_s:.4f} s, self {self_s:.4f} s; "
                   + ", ".join(f"{k} {v:.4f}"
                               + (f" {attrs[k]}" if attrs[k] else "")
                               for k, v in heavy))
    return out


def _attr_lines(trace):
    """Each span under the exposure and seam stages, in order, with its
    attributes."""
    out = []
    for i, s in enumerate(trace.spans):
        if s.parent == 0 and s.name in ("Compensating exposure",
                                        "Finding seams"):
            out += [f"{s.name} > {c.name}: {c.seconds:.4f} s"
                    + (f" {c.attrs}" if c.attrs else "")
                    for c in trace.children(i)]
    return out


def _write_rig(directory: str) -> None:
    """The benchmark's rig37 capture set of seed 7, rendered on the card
    and written as JPEGs with their EXIF pose priors."""
    from concurrent.futures import ThreadPoolExecutor
    from benchmark import run, scene
    capture = run.Cell("rig37.stitch").config["capture"]
    tex_seed, noise_seed = scene.set_seeds(7, 1)[0]
    with ThreadPoolExecutor(max_workers=8) as pool:
        _, futures = scene.make_capture_set(directory, capture, tex_seed,
                                            noise_seed, "cuda", pool)
        for f in futures:
            f.result()


def _innermost_gaps(events, names, lo: float, hi: float):
    """The device's idle gaps in [lo, hi] (profiler us) as (label,
    seconds): the path of span ranges that held the host when the gap
    began, innermost last, or "outside every span"."""
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name in names)
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(ranges)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(ranges)])
    starts, labels, stack = [], [], []
    for t, opening, i in marks:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        path = [ranges[j][2] for j in stack]
        starts.append(t)
        labels.append(" > ".join(path[1:] if path[1:] else path))
    busy = merged(device_spans(events), lo, hi)
    edges = [lo] + [t for s in busy for t in s] + [hi]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            k = bisect.bisect_right(starts, a) - 1
            gaps.append(((labels[k] if k >= 0 else "")
                         or "outside every span", (b - a) / 1e6))
    return gaps


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_stitch: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.data.synth import (DEFAULT_RING,
                                                      write_ring_dir)
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    args = sys.argv[1:]
    legacy = "--legacy" in args
    resume = "--resume" in args
    rig = "--rig" in args
    args = [a for a in args if a not in ("--legacy", "--resume", "--rig")]
    smi = _smi()
    with tempfile.TemporaryDirectory(prefix="profile_") as work:
        caps = os.path.join(work, "caps")
        if rig:
            _write_rig(caps)
        else:
            write_ring_dir(caps, **DEFAULT_RING)
        cfg = StitchConfig(fast_ingest=not legacy, checkpoint_dir=work)
        if resume:
            stitch(caps, cfg, output="", device="cuda")
            cfg = dataclasses.replace(cfg, serialize_data=False)
        print(f"captures: {'rig37' if rig else 'DEFAULT_RING'}; "
              f"configuration: StitchConfig("
              f"{'fast_ingest=False' if legacy else ''}"
              f"{', serialize_data=False' if resume else ''}) (checkpoints "
              f"in a temporary directory)")
        warm = stitch(caps, cfg, output="", device="cuda").trace
        walls, traces = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = stitch(caps, cfg, output="", device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            traces.append(res.trace)
        print(f"walls (s): {walls}; stages of the last: "
              f"{res.stage_times}; card '{smi}'")
        untraced = [trace_spans.untraced_pct(t) for t in traces]
        counters = {k: [t.counters.get(k, 0) for t in traces]
                    for k in sorted({k for t in traces for k in t.counters})}
        print(f"spans a stitch: {[len(t.spans) for t in traces]}; untraced "
              f"% of the root: {untraced}; counters: {counters}")
        for line in _span_lines(traces):
            print(line)
        for line in _attr_lines(traces[-1]):
            print(line)
        print(f"warm-up: {warm.root.seconds:.4f} s")
        for line in _span_lines([warm]):
            print(f"warm-up {line}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stitch(caps, cfg, output="", device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    spans = device_spans(events)
    busy = busy_seconds(spans) * 1e3
    n_kernels = len(spans)
    print(f"profiled wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.2f}%), idle "
          f"{100 * (1 - busy / (wall * 1e3)):.2f}%, {n_kernels} device "
          f"events; card '{smi}'")
    for line in _stage_lines(events, spans, set(res.stage_times)):
        print(line)
    root = [e for e in events if e.name == "stitch"
            and e.device_type == torch.autograd.DeviceType.CPU][-1]
    gaps = _innermost_gaps(events, {s.name for t in traces for s in t.spans},
                           root.time_range.start, root.time_range.end)
    idle = collections.Counter()
    for label, secs in gaps:
        idle[label] += secs
    print("longest idle gaps (s): " + "; ".join(
        f"{label} {secs:.4f}" for label, secs in
        sorted(gaps, key=lambda g: -g[1])[:10]))
    print("idle by innermost span (s): " + "; ".join(
        f"{label} {secs:.4f}" for label, secs in idle.most_common(10)))
    hand = ("orb_detect_maps_kernel", "orb_sample_levels_kernel",
            "warp_bilinear_kernel", "hamming_unpack_kernel",
            "hamming_wgmma_kernel", "pyr_down_batch_kernel",
            "band_accumulate_batch_kernel", "ransac_score_kernel")
    by_launch = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                any(k in e.name for k in hand):
            by_launch.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    for avg in prof.key_averages():
        if any(k in avg.key for k in hand):
            total_us = getattr(avg, "device_time_total", None)
            if total_us is None:
                total_us = avg.cuda_time_total
            each = ", ".join(f"{ms:.4f}" for ms in by_launch.get(avg.key, []))
            print(f"kernel {avg.key[:60]}: {avg.count} launches, "
                  f"{total_us / 1e3:.4f} ms device "
                  f"({100 * total_us / 1e3 / busy:.3f}% of busy); by launch "
                  f"(ms): {each}")
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    if args:
        os.makedirs(os.path.dirname(os.path.abspath(args[0])),
                    exist_ok=True)
        with open(args[0], "w") as f:
            f.write(f"card: {smi}\n{table}\n")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
