"""Where the time goes in the PyTorch port's stitch, on one CUDA GPU.

Run from the repository root:
    python3 -m tools.profile_torch_stitch [OUT_TXT]

Renders the 8 x 2448x3264 e2e ring (`data/synth.py` E2E_RING), runs stitch() once to warm up
and three times timed, then once under torch.profiler (CPU + CUDA
activities).  Prints the stage times, the device-busy share of the wall
time, the two CUDA kernels' device time and the ops by total device time;
with OUT_TXT, the 40-row table is also written there.
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


def _busy_ms(events) -> float:
    """Union of the CUDA kernel intervals (ms): device-busy time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_stitch: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.data.synth import E2E_RING, write_ring_dir
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    smi = _smi()
    with tempfile.TemporaryDirectory(prefix="profile_") as work:
        caps = os.path.join(work, "caps")
        write_ring_dir(caps, **E2E_RING)
        cfg = StitchConfig(num_features=1500, work_megapix=1.9,
                           expos_comp_type="no", seam_find_type="no",
                           fast_ingest=False, checkpoint_dir=work)
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
    busy = _busy_ms(events)
    n_kernels = sum(1 for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.2f}%), idle "
          f"{100 * (1 - busy / (wall * 1e3)):.2f}%, {n_kernels} device "
          f"events; card '{smi}'")
    for avg in prof.key_averages():
        if "orb_sample_kernel" in avg.key or "warp_bilinear_kernel" in avg.key:
            total_us = getattr(avg, "device_time_total", None)
            if total_us is None:
                total_us = avg.cuda_time_total
            print(f"kernel {avg.key[:60]}: {avg.count} launches, "
                  f"{total_us / 1e3:.4f} ms device "
                  f"({100 * total_us / 1e3 / busy:.3f}% of busy)")
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as f:
            f.write(f"card: {smi}\n{table}\n")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
