"""What RANSAC's draws cost on the card: the default stitch's "Pairwise
matching" stage and the pair batch, for an A/B of two checkouts.

Run from the root of a checkout of the port, on one CUDA GPU:
    python3 /path/to/tools/draws_ab.py CAPS_DIR [LABEL]

Renders DEFAULT_RING (8 x 2448x3264, sigma-8 noise) into CAPS_DIR unless
it is there already, so several checkouts stitch the same files.  Then,
with the checkout's own package (the current directory's): stitch() under
`StitchConfig()` once to warm up, three times timed ("Pairwise matching"
seconds and the wall, each run fenced), and once under torch.profiler
counting the kernel launches the host makes inside "Pairwise matching";
then bench.py's `pairs` batch (64 noise pairs of 480x640, seed 0, 1024
features, n_hyp 512) through `make_batched_register` on a dp mesh of the
card: pairs/s over 3 batches with fresh content after a warm-up, with
keys split(PRNGKey(0), 64), or per-pair seeds 0..63 on a checkout from
before the port took threefry keys.  Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _matching_launches(stitch, caps, cfg) -> int:
    """Kernel launches the host makes inside "Pairwise matching" in one
    profiled stitch."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stitch(caps, cfg, output="", device="cuda")
        torch.cuda.synchronize()
    events = prof.events()
    (lo, hi), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name == "Pairwise matching"]
    return sum(1 for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and "LaunchKernel" in e.name
               and lo <= e.time_range.start <= hi)


def _pairs_per_s(dev) -> float:
    from image_stitching_tpu_torch.parallel.batched import (
        make_batched_register)
    from image_stitching_tpu_torch.parallel.mesh import make_mesh
    batch, (h, w), reps = 64, (480, 640), 3
    try:
        from image_stitching_tpu_torch.core.prng import PRNGKey, split
        draws = split(PRNGKey(0, dev), batch)
    except ImportError:                # the batch took per-pair seeds
        draws = np.arange(batch)
    fn = make_batched_register(make_mesh((1, 1), devices=[dev]), (h, w),
                               n_features=1024, n_hyp=512)
    rng = np.random.default_rng(0)
    pairs = torch.as_tensor(rng.uniform(0, 255, (batch, 2, h, w))
                            .astype(np.float32), device=dev)
    fn(pairs, draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(pairs + float(i + 1), draws)
    torch.cuda.synchronize()
    return reps * batch / (time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("draws_ab: no CUDA device", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.data.synth import (DEFAULT_RING,
                                                      write_ring_dir)
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    caps = os.path.abspath(sys.argv[1])
    label = sys.argv[2] if len(sys.argv) > 2 else os.getcwd()
    if not os.path.isdir(caps):
        write_ring_dir(caps, **DEFAULT_RING)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="draws_ab_") as work:
        cfg = StitchConfig(checkpoint_dir=work)
        stitch(caps, cfg, output="", device="cuda")
        matching_s, walls = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = stitch(caps, cfg, output="", device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            matching_s.append(res.stage_times["Pairwise matching"])
        launches = _matching_launches(stitch, caps, cfg)
    print(json.dumps(dict(
        label=label, kept=len(res.kept_indices),
        pairwise_matching_s=matching_s, wall_s=walls,
        pairwise_matching_launches=launches,
        pairs_per_s=_pairs_per_s(dev), card=_smi())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
