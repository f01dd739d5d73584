"""Readings that set a cell's limits: the program's and the control's
numbers over many seeds, in one process on the CUDA card.

    python3 -m benchmark.calibrate <cell> <seed> [<seed> ...] \
        [--faults half,exposure,seams] [--fault-seeds N] [--out FILE]

For each seed: the cell's capture sets (`run.set_up`), one stitch of each
window set (as the window calls it, at the cell's sizes), the numbers
`loop.judge` compares, and the same numbers for the control: the
reference computed in bfloat16, the precision below the configuration's
float32, in the program's place.  On the first N seeds (all by default),
each named fault of `faults.py` stitches the same sets again and is
judged.  The first seed's warm-up stitch is not judged.  One JSON line a
seed, on standard output and appended to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.kernels import _build
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    from . import faults, loop, run
    cell = run.Cell(args.cell)
    dev = run.Device(torch.device("cuda", 0))
    _build.load_library()
    print(f"card: {run.smi()}", file=sys.stderr)
    names = [f for f in args.faults.split(",") if f]
    fault_seeds = args.fault_seeds or len(args.seeds)
    for n_seed, seed in enumerate(args.seeds):
        workdir = tempfile.mkdtemp(prefix="stitch_calib_")
        try:
            t0 = time.perf_counter()
            sets, output, _, _ = run.set_up(cell, seed, workdir, dev, stitch,
                                            warm=n_seed == 0)
            n = len(sets) - 1
            window = loop.run_window(stitch, sets, 0.0, output, seed,
                                     dev.device, min_stitches=n)
            t1 = time.perf_counter()
            program = loop.judge(window, sets, cell.config)
            t2 = time.perf_counter()
            control = loop.judge(window, sets, cell.config, control=True)
            broken = {}
            for name in names if n_seed < fault_seeds else []:
                w = loop.run_window(faults.FAULTS[name](stitch), sets, 0.0,
                                    output, seed, dev.device, min_stitches=n)
                broken[name] = dict(loop.judge(w, sets, cell.config),
                                    failed=w.failed)
            line = {"cell": cell.name, "seed": seed, "program": program,
                    "control": control, "faults": broken,
                    "failed": window.failed,
                    "kept": [len(r.kept) for r in window.records],
                    "gains": [list(c.gains) for c, _ in sets],
                    "walls": [r.wall_s for r in window.records],
                    "prepare_and_stitch_s": t1 - t0, "check_s": t2 - t1,
                    "card": torch.cuda.get_device_name(0)}
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
