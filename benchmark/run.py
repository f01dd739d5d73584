"""Run one cell of the benchmark once, on the CUDA card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of `BENCHMARK.json`'s
`workloads`; its configuration is `benchmark/configs/<config>.json`, its
traffic `benchmark/traffic/<traffic>.json` with the overrides of
`benchmark/workloads/<cell>.json`, and each metric a reader in
`benchmark/metrics/<metric>.py`, or `benchmark/metrics/<metric>.json`
naming the program's stage whose mean seconds a stitch it reads: a cell,
configuration, traffic mix or metric is added by adding files and
entries, not by editing this one.

A run: refuse without a CUDA card; load the program's kernel library and
native runtime (their build caches are the program's own, inside the
checkout); render the capture sets from the seed under TMPDIR; stitch set
0 once to warm up; then a closed loop of one client for `--seconds`
(`loop.py`).  `--trace 0` prints the cell's end-to-end metrics; `--trace
1` runs the same window, then profiles `profile_stitches` more stitches
and prints the per-layer metrics, the device's busy time and the
breakdown.  Every run judges what its window returned against the plain
reference (`reference.py`), prints each number beside its limit as the
last lines of standard error and under `checks`, last, in the result.
The result is the last line of standard output.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List  # noqa: E402

import numpy as np  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "image_stitching_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of `BENCHMARK.json` and everything its name leads to."""

    def __init__(self, name: str, root: str = ROOT):
        bench = os.path.join(root, "benchmark")
        self.manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = load_json(os.path.join(
            bench, "configs", f"{self.entry['config']}.json"))
        spec = load_json(os.path.join(bench, "workloads", f"{name}.json"))
        for key in ("config", "traffic"):
            if spec[key] != self.entry[key]:
                raise ValueError(f"workloads/{name}.json names {key} "
                                 f"{spec[key]!r}, BENCHMARK.json "
                                 f"{self.entry[key]!r}")
        self.params = dict(load_json(os.path.join(
            bench, "traffic", f"{self.entry['traffic']}.json")))
        self.params.pop("why", None)
        self.params.update(spec.get("params", {}))
        self.limits: Dict[str, float] = spec["limits"]
        self.metrics_dir = os.path.join(bench, "metrics")

    def metrics(self, section: str) -> List[dict]:
        """The `end_to_end` or `per_layer` metrics this cell reports: those
        without `workloads`, and those whose `workloads` name it."""
        return [m for m in self.manifest[section]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        """`metrics/<metric>.py`'s `read(ctx)`; for a `metrics/<metric>.json`
        of {"stage": name}, the mean seconds a stitch of the window that
        `StitchResult.stage_times` gives the stage (the program fences each
        stage with `torch.cuda.synchronize`), nothing where no stitch ran
        it.  A `<base>.<variant>` with no file of its own reads as
        `<base>`."""
        path = os.path.join(self.metrics_dir, f"{metric}.py")
        stage_path = os.path.join(self.metrics_dir, f"{metric}.json")
        if not (os.path.exists(path) or os.path.exists(stage_path)) and (
                "." in metric):
            # <base> split by the end-to-end metric it moves in some cells.
            return self.reader(metric.rsplit(".", 1)[0])
        if not os.path.exists(path):
            stage = load_json(stage_path)["stage"]
            return lambda ctx: ctx.stage_means.get(stage)
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def smi() -> str:
    """The card's name, power limit and clocks, from nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err})"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Context:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@contextlib.contextmanager
def kernel_recorders(k4_calls: list, k5_calls: list):
    """Pass-through wrappers on the program's K4 and K5 entry points as the
    stitch calls them, keeping each call's shapes for the rooflines."""
    from image_stitching_tpu_torch.ops import matching
    from image_stitching_tpu_torch.pipeline import compose_fused
    k4, k5 = matching.hamming_two_nn_pairs, compose_fused.pyramid_accumulate

    def rec_k4(desc, valid, ii, jj):
        k4_calls.append((desc.shape[1], desc.shape[2], valid, ii, jj))
        return k4(desc, valid, ii, jj)

    def rec_k5(warped, weight, offs, accs, n_bands):
        k5_calls.append(((warped.shape[0], warped.shape[2], warped.shape[3]),
                         [tuple(int(v) for v in o) for o in offs],
                         [tuple(a.shape[1:]) for a in accs], n_bands))
        return k5(warped, weight, offs, accs, n_bands)
    matching.hamming_two_nn_pairs = rec_k4
    compose_fused.pyramid_accumulate = rec_k5
    try:
        yield
    finally:
        matching.hamming_two_nn_pairs = k4
        compose_fused.pyramid_accumulate = k5


def profile(stitch, sets, n: int, output: str, device):
    """n more stitches under torch.profiler (CPU + CUDA) with the kernel
    recorders on: (TraceSummary, k4 calls, k5 calls, records)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from . import loop, yardstick
    k4_calls, k5_calls, records = [], [], []
    t0 = time.perf_counter()
    with kernel_recorders(k4_calls, k5_calls), torch_profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with torch.profiler.record_function("benchmark.profiled"):
            for i in range(n):
                s = 1 + i % (len(sets) - 1)
                cset, cfg = sets[s]
                res = stitch(cset.directory, cfg, output=output,
                             device=device)
                torch.cuda.synchronize()
                records.append(loop.Record(s, 0.0, list(res.kept_indices),
                                           res.cameras, res.work_scale,
                                           dict(res.stage_times)))
                del res
    t1 = time.perf_counter()
    events = prof.events()
    t2 = time.perf_counter()
    outer = [e for e in events if e.name == "benchmark.profiled"
             and e.device_type == torch.autograd.DeviceType.CPU][0]
    stages = {k for r in records for k in r.stage_times}
    summary = yardstick.TraceSummary(events, n, outer.time_range.start,
                                     outer.time_range.end, stages)
    print(f"profile: {n} stitches in {t1 - t0:.3f} s, {len(events)} events "
          f"read in {t2 - t1:.3f} s, reduced in "
          f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
    return summary, k4_calls, k5_calls, records


class Device:
    """The run's device: the CUDA card, or the CPU where tests drive the
    rest of a run; memory readings are the card's, 0 on the CPU."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def empty_cache(self):
        if self.cuda:
            self.torch.cuda.empty_cache()

    def kind(self) -> str:
        return (self.torch.cuda.get_device_name(self.device) if self.cuda
                else "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.kernels import _build
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    print(f"card: {smi()}", file=sys.stderr)
    _build.load_library()
    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    Device(torch.device("cuda", 0)), stitch)


def set_up(cell: Cell, seed: int, workdir: str, dev: Device, stitch,
           warm: bool = True):
    """A run's set-up after the kernel library: the native runtime, the
    capture sets of the seed under workdir, and (with `warm`) one stitch of
    set 0.  Returns (sets, output path, render seconds, warm-up
    seconds)."""
    import torch
    from image_stitching_tpu_torch.core import native
    from . import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native.load()
    t_render = time.perf_counter()
    sets = loop.prepare(cell.config, cell.params, seed, workdir, dev.device)
    render_s = time.perf_counter() - t_render
    output = os.path.join(workdir, "result.jpg")
    t_warm = time.perf_counter()
    if warm:
        stitch(sets[0][0].directory, sets[0][1], output=output,
               device=dev.device)
        dev.sync()
    return sets, output, render_s, time.perf_counter() - t_warm


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             dev: Device, stitch, min_stitches: int = 0) -> int:
    """Everything of a run after the look for a card: set-up, the window,
    the traced stitches, the judgement and the result line."""
    from . import loop
    workdir = tempfile.mkdtemp(prefix="stitch_bench_")
    try:
        sets, output, render_s, warm_s = set_up(cell, seed, workdir, dev,
                                                stitch)
        gc.collect()
        dev.reset_peak()
        setup_s = time.perf_counter() - _T0
        window = loop.run_window(stitch, sets, seconds, output, seed,
                                 dev.device, min_stitches)
        peak = dev.peak_bytes()
        trace_sum = k4_calls = k5_calls = None
        extra = []
        if trace:
            trace_sum, k4_calls, k5_calls, extra = profile(
                stitch, sets, int(cell.params["profile_stitches"]), output,
                dev.device)
        loaded = forbidden_modules()
        if loaded:
            print(f"benchmark: the run loaded {loaded}; the port must not "
                  "import JAX or the JAX package", file=sys.stderr)
            return 3
        gc.collect()
        dev.empty_cache()
        t_check = time.perf_counter()
        n = len(window.records)
        window.records.extend(extra)
        numbers = loop.judge(window, sets, cell.config)
        check_s = time.perf_counter() - t_check
        correct = loop.verdict(numbers, cell.limits, n, window.failed)
        walls = [r.wall_s for r in window.records[:n]]
        stage_means: Dict[str, float] = {}
        for r in window.records[:n]:
            for k, v in r.stage_times.items():
                stage_means[k] = stage_means.get(k, 0.0) + v / n
        mp = sum(sets[r.set_index][0].megapixels
                 for r in window.records[:n])
        ctx = Context(walls=walls, window_s=window.window_s, megapixels=mp,
                      peak_bytes=peak, setup_s=setup_s,
                      stage_means=stage_means, trace=trace_sum,
                      k4_calls=k4_calls, k5_calls=k5_calls)
        section = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in cell.metrics(section):
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"platform": "gpu" if dev.cuda else "cpu",
                       "kind": dev.kind(), "count": cell.chips,
                       "memory_peak_bytes": peak}
        result = {"correct": correct, "attempted": n,
                  "failed": window.failed, "metrics": metrics,
                  "device": device_info}
        if trace_sum is not None:
            device_info["busy_s"] = trace_sum.busy_s
            device_info["window_s"] = trace_sum.window_s
            result["breakdown"] = trace_sum.breakdown()
        result["checks"] = loop.render_check(numbers, cell.limits)
        kept = loop.kept_counts(window.records)
        print(f"run: {cell.name} seed {seed}: {n} stitches in "
              f"{window.window_s:.4f} s ({window.failed} failed), walls "
              f"median {statistics.median(walls) if walls else 0:.4f} s; "
              f"set-up {setup_s:.3f} s (render {render_s:.3f} s, warm-up "
              f"stitch {warm_s:.3f} s); check {check_s:.3f} s; peak "
              f"{peak / 2 ** 30:.4f} GiB", file=sys.stderr)
        print("walls (s): " + " ".join(f"{w:.4f}" for w in walls),
              file=sys.stderr)
        print("stage means (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in stage_means.items()), file=sys.stderr)
        print(f"kept views per set (of {sets[1][0].n_images}): {kept}; "
              f"reprojection {numbers['reproj_px']:.6f} px; exposure gains "
              f"per set {[list(np.round(c.gains, 4)) for c, _ in sets]}",
              file=sys.stderr)
        if dev.cuda:
            print(f"card: {smi()}", file=sys.stderr)
        for k, v in result["checks"].items():
            print(f"check {k}: {v['value']:.6g} (limit {v['limit']:g})",
                  file=sys.stderr)
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
