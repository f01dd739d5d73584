"""Where the time goes in the PyTorch port's stitch, on one CUDA GPU.

Run from the repository root:
    python3 -m tools.profile_torch_stitch [--legacy] [OUT_TXT]

Renders the 8 x 2448x3264 ring DEFAULT_RING (`data/synth.py`, sigma-8
noise), runs stitch() with the reference defaults, `StitchConfig()` (fast
ingest; with --legacy the legacy decode, fast_ingest=False), once to warm
up and three times timed, then
once under torch.profiler (CPU + CUDA activities).  Prints the stage
times, the device-busy share of the wall time, per stage its kernel
launches and device-busy time, each hand kernel's launches and device
time (with each launch's, in launch order), and the ops by total device
time; with OUT_TXT, the 40-row table
is also written there.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _device_spans(events):
    """(start, end) us of the device's work: kernels, copies and sets, not
    the user-annotation ranges the profiler mirrors onto the device."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def _busy_ms(spans, lo=float("-inf"), hi=float("inf")) -> float:
    """Union of the device spans clipped to [lo, hi] (ms): device-busy
    time."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


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
        busy = _busy_ms(spans, lo, hi)
        wall = (hi - lo) / 1e3
        out.append(f"stage {name}: wall {wall:.3f} ms, {n} kernel launches, "
                   f"device busy {busy:.3f} ms "
                   f"({100 * busy / max(wall, 1e-9):.2f}%)")
    return out


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
    args = [a for a in args if a != "--legacy"]
    smi = _smi()
    with tempfile.TemporaryDirectory(prefix="profile_") as work:
        caps = os.path.join(work, "caps")
        write_ring_dir(caps, **DEFAULT_RING)
        cfg = StitchConfig(fast_ingest=not legacy, checkpoint_dir=work)
        print(f"configuration: StitchConfig("
              f"{'fast_ingest=False' if legacy else ''}) (checkpoints in a "
              f"temporary directory)")
        stitch(caps, cfg, output="", device="cuda")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = stitch(caps, cfg, output="", device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"walls (s): {walls}; stages of the last: "
              f"{res.stage_times}; card '{smi}'")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stitch(caps, cfg, output="", device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    spans = _device_spans(events)
    busy = _busy_ms(spans)
    n_kernels = len(spans)
    print(f"profiled wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.2f}%), idle "
          f"{100 * (1 - busy / (wall * 1e3)):.2f}%, {n_kernels} device "
          f"events; card '{smi}'")
    for line in _stage_lines(events, spans, set(res.stage_times)):
        print(line)
    hand = ("orb_sample_levels_kernel", "warp_bilinear_kernel",
            "hamming_unpack_kernel", "hamming_pairs_kernel",
            "pyr_down_batch_kernel", "band_accumulate_batch_kernel")
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
