"""The port's smoke run on a CUDA card: the main path of the benchmark's
stitch cells, each hand kernel held to its plain version on the calls that
path makes, then timed there beside its bound.

Run from the repository root on a machine with a CUDA card:
    python3 chip_smoke.py

For each of `benchmark/configs/ring8.json` and `rig37.json` it renders one
capture set as the benchmark does (`benchmark.loop.prepare`) and runs one
`stitch()` with the configuration's `StitchConfig`, each wrapper's
`.launches` zeroed just before it, recording every call of K1
(`orb_sample_levels`), K2 (`warp_bilinear`), K4 (`hamming_two_nn_pairs`),
K5 (`pyramid_accumulate`), K6 (`orb_detect_maps`) and K7
(`ransac_score_counts`) as the stitch makes it.  Every kernel must have
launched.  The calls of one kernel at one shape make one row; the first
of them is held to the kernel's plain version by the card tests' gates
(`tests/_torch_port.py`: `check_k1` .. `check_k7`), a failed gate ending
the run, and then timed:

- `device_ms`: CUDA events around the replays of a CUDA graph of 20 calls
  (`device_ms`), so the host wrapper is left out and the inputs are warm
  in L2;
- `call_ms`: CUDA events around back-to-back wrapper calls (`time_ms`),
  what a caller pays;
- `plain_ms`: the kernel's plain PyTorch version on the same inputs;
- `launches`: the kernel nodes of a CUDA graph of one call
  (`kernel_launches`);
- `bound_ms` and `bound_by`: `benchmark.yardstick`'s `bound`, `k4_bound`
  and `k5_union_bytes` on the call's bytes and operations, the rooflines
  that the benchmark's `k4_roofline_pct` and `k5_roofline_pct` read.

Prints the card's name and power limit, one line a row, each stitch's
launches by wrapper, and last a JSON line `{"card", "kernels": [rows],
"launches": {config: {kernel: n}}}`.  Exits 0 when every gate held.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from benchmark import yardstick

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from _torch_port import (check_k1, check_k2, check_k4, check_k5,  # noqa: E402
                         check_k6, check_k7, kernel_launches)

CONFIGS = ("ring8", "rig37")
# K1: the disk's pixels (radius 20), and per keypoint the disk's two moment
# sums (4 a pixel), 512 rotations and rounds (8 each) and 256 compares.
DISK = [(y, x) for y in range(-20, 21) for x in range(-20, 21)
        if x * x + y * y <= 400]
# K6, a level pixel counted once: the resize (9), FAST (160), Sobel and
# products (23), the box sums (147), Harris (7), the 3x3 NMS (9), the blur
# (28).
K6_OPS_PER_PIXEL = 9 + 160 + 23 + 147 + 7 + 9 + 28
# K7, a point test: the projection (12), two divisions, two subtractions
# and the squared error (3).
K7_OPS_PER_TEST = 12 + 2 + 2 + 3
K7_PLAIN_PAIRS = 16     # pairs a plain call takes at once


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms of one fn() over `reps` back-to-back calls, CUDA events
    around them: the host wrapper's enqueue is in it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms of one fn(): CUDA events around the replays of a CUDA
    graph of `reps` fn() calls.  fn must launch nothing but the kernels it
    times; the graph's kernel-to-kernel gaps are in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def _resize_taps(n_src: int, n_dst: int) -> int:
    """Source rows (or columns) the bilinear resize reads for n_dst."""
    s = np.float64(np.float32(n_src / n_dst))
    src = ((np.arange(n_dst) + 0.5) * s - 0.5).astype(np.float32)
    y0 = np.clip(np.floor(src), 0, n_src - 1).astype(np.int64)
    return int(np.unique(np.concatenate(
        [y0, np.minimum(y0 + 1, n_src - 1)])).size)


def k1_cost(raws, blurs, xy, lvl, pat, radius):
    """K1's bytes and operations: per level the union of the keypoints'
    disks in the level plane and of their rounded sample coordinates in
    the blurred plane, each pixel read once; keypoints and pattern in,
    angle, moments and descriptors out."""
    from image_stitching_tpu_torch.kernels.orb_sample import (
        N_SAMPLES, orb_sample_levels)
    angle = orb_sample_levels(raws, blurs, xy, lvl, pat, radius)[1]
    dy, dx = (torch.tensor(v, device=xy.device) for v in zip(*DISK))
    n_px = 0
    for i, raw in enumerate(raws):
        sel = lvl == i
        h, w = raw.shape
        cx = torch.round(xy[sel, 0]).long().clamp(0, w - 1)
        cy = torch.round(xy[sel, 1]).long().clamp(0, h - 1)
        rows = (cy[:, None] + dy).clamp(0, h - 1)
        cols = (cx[:, None] + dx).clamp(0, w - 1)
        n_px += int(torch.unique(rows * w + cols).numel())
        ca, sa = torch.cos(angle[sel])[:, None], torch.sin(angle[sel])[:, None]
        gx = torch.round(xy[sel, 0:1] + ca * pat[0] - sa * pat[1])
        gy = torch.round(xy[sel, 1:2] + sa * pat[0] + ca * pat[1])
        n_px += int(torch.unique(gy.clamp(0, h - 1).long() * w +
                                 gx.clamp(0, w - 1).long()).numel())
    k = xy.shape[0]
    n_bytes = 4 * n_px + k * (8 + 4) + pat.numel() * 4 + k * (4 + 8 + 32)
    return n_bytes, k * (len(DISK) * 4 + N_SAMPLES * 8 + 256)


def k6_cost(gray, level, lh, lw, *_):
    """K6's bytes and operations on one level: the source rows and columns
    the level's resize reads in, four f32 planes out."""
    h, w = gray.shape
    n_in = (h * w if level == 0 else
            _resize_taps(h, lh) * _resize_taps(w, lw)) * gray.element_size()
    return n_in + 16 * lh * lw, K6_OPS_PER_PIXEL * lh * lw


def k5_cost(warped, weight, offs, accs, nb):
    """K5's bytes (`yardstick.k5_union_bytes`: the rects in, the union of
    their windows in every band read and written once) and operations (a
    4-channel 5x5 pyrDown a level, 3x3 pyrUp taps of 3 channels,
    subtract, weight and add a band pixel)."""
    n, _, ph, pw = warped.shape
    n_bytes = yardstick.k5_union_bytes(
        (n, ph, pw), [tuple(int(v) for v in o) for o in offs],
        [tuple(a.shape[1:]) for a in accs], nb)
    n_ops = n * (sum(4 * 50 * (ph >> b) * (pw >> b) for b in range(1, nb + 1))
                 + sum((3 * 18 + 12) * (ph >> b) * (pw >> b)
                       for b in range(nb + 1)))
    return n_bytes, n_ops


def kernels():
    """{name: (module, attribute, plain, key of a call, cost or None,
    gate)}: the module whose attribute the stitch calls the kernel by."""
    from image_stitching_tpu_torch.kernels import (
        hamming, multiband, orb_detect, orb_sample, ransac_score,
        warp_gather)
    from image_stitching_tpu_torch.ops import matching, ransac
    from image_stitching_tpu_torch.ops.features import orb
    from image_stitching_tpu_torch.pipeline import compose_fused

    def k7_plain(h_all, src, dst, idx, thresh):
        for a in range(0, h_all.shape[0], K7_PLAIN_PAIRS):
            cut = slice(a, a + K7_PLAIN_PAIRS)
            ransac_score.ransac_score_counts_plain(
                h_all[cut], src[cut], dst[cut], idx[cut], thresh)
    return {
        "K1 orb_sample_levels": (
            orb, "orb_sample_levels", orb_sample.orb_sample_levels_plain,
            lambda a: (tuple(tuple(r.shape) for r in a[0]), len(a[2])),
            k1_cost, lambda a, kw: check_k1(*a, **kw)),
        "K6 orb_detect_maps": (
            orb, "orb_detect_maps", orb_detect.orb_detect_maps_plain,
            lambda a: (tuple(a[0].shape), str(a[0].dtype)) + tuple(a[1:4]),
            k6_cost, lambda a, kw: check_k6(*a, **kw)),
        "K4 hamming_two_nn_pairs": (
            matching, "hamming_two_nn_pairs",
            hamming.hamming_two_nn_pairs_plain,
            lambda a: (tuple(a[0].shape), len(a[2])), None,
            lambda a, kw: check_k4(a)),
        "K7 ransac_score_counts": (
            ransac, "ransac_score_counts", k7_plain,
            lambda a: (tuple(a[0].shape), tuple(a[3].shape),
                       tuple(a[1].shape)),
            lambda h, s, d, i, t: (
                h.shape[0] * h.shape[1] * 44 + i.numel() * 24,
                K7_OPS_PER_TEST * h.shape[0] * h.shape[1] * i.shape[1]),
            lambda a, kw: check_k7([(a, kw, None)])),
        "K2 warp_bilinear": (
            compose_fused, "warp_bilinear", warp_gather.warp_bilinear_plain,
            lambda a: (tuple(a[0].shape), tuple(a[1].shape)),
            lambda src, sx, sy: (src.numel() * src.element_size() +
                                 sx.numel() * 20, sx.numel() * 44),
            lambda a, kw: check_k2([(a, kw, None)])),
        "K5 pyramid_accumulate": (
            compose_fused, "pyramid_accumulate",
            multiband.pyramid_accumulate_plain,
            lambda a: (tuple(a[0].shape), a[4],
                       tuple(tuple(x.shape) for x in a[3])), k5_cost,
            lambda a, kw: check_k5([(a, kw, None)])),
    }


def record(stitch_once, table):
    """Run stitch_once() with every kernel of `table` wrapped and its
    `.launches` zeroed: ({name: {key: [first call's args, kwargs,
    count]}}, {name: launches in the stitch})."""
    calls = {name: {} for name in table}
    wrappers = {name: getattr(mod, attr)
                for name, (mod, attr, *_) in table.items()}

    def keeper(name, fn, key):
        def keep(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen = calls[name].setdefault(key(args), [args, kwargs, 0])
            seen[2] += 1
            return out
        return keep
    with ExitStack() as stack:
        for name, (mod, attr, _, key, *_) in table.items():
            stack.enter_context(mock.patch.object(
                mod, attr, keeper(name, wrappers[name], key)))
        for fn in wrappers.values():
            fn.launches = 0
        stitch_once()
    torch.cuda.synchronize()
    return calls, {name: fn.launches for name, fn in wrappers.items()}


def row(config, name, entry, args, kwargs, count):
    """One row: the kernel held to its plain version on a call, then its
    times, launches and bound there."""
    mod, attr, plain, key, cost, gate = entry
    gate(args, kwargs)
    fn = getattr(mod, attr)
    if name.startswith("K5"):       # fresh accumulators, written in place
        warped, weight, offs, accs, nb = args
        args = (warped, weight, offs, [torch.zeros_like(a) for a in accs],
                nb)
    if name.startswith("K4"):
        desc, valid, ii, jj = args
        b = yardstick.k4_bound(desc.shape[1], desc.shape[2],
                               valid.sum(-1).tolist(), ii.tolist(),
                               jj.tolist())
        bound_ms = b["bound_ms"]
        bound_by = ("bytes" if bound_ms <= b["t_bytes"] else
                    "operations, tensor cores" if b["tensor_ms"] <=
                    b["cuda_core_ms"] else "operations, CUDA cores")
    else:
        bound_ms, bound_by = yardstick.bound(*cost(*args, **kwargs))
    dev = device_ms(lambda: fn(*args, **kwargs))
    return dict(config=config, kernel=name, shape=str(key(args)),
                calls=count, checked=True, device_ms=dev,
                call_ms=time_ms(lambda: fn(*args, **kwargs)),
                plain_ms=time_ms(lambda: plain(*args, **kwargs), reps=3),
                launches=kernel_launches(lambda: fn(*args, **kwargs)),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_pct=100.0 * bound_ms / dev)


def table_of(config_name: str, workdir: str, dev: torch.device):
    """One configuration on `dev`: one capture set, one recorded stitch,
    its rows and its launches by kernel."""
    from benchmark import loop
    from image_stitching_tpu_torch.pipeline.stitcher import stitch
    with open(os.path.join("benchmark", "configs",
                           f"{config_name}.json")) as f:
        config = json.load(f)
    (cset, cfg), = loop.prepare(config, {"sets": 0, "resume": False}, 0,
                                os.path.join(workdir, config_name), dev)
    table = kernels()
    calls, launches = record(lambda: stitch(
        cset.directory, cfg, output=os.path.join(workdir, "result.jpg"),
        device=dev), table)
    print(f"{config_name} launches in the stitch: {launches}", flush=True)
    assert all(launches.values()), (config_name, launches)
    rows = []
    for name, entry in table.items():
        for args, kwargs, count in calls[name].values():
            rows.append(row(config_name, name, entry, args, kwargs, count))
            r = rows[-1]
            print(f"{config_name} {name} {r['shape']} x{count}: gates "
                  f"held; device {r['device_ms']:.4f} ms, call "
                  f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"{r['launches']} launches, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), {r['bound_pct']:.1f}% of it",
                  flush=True)
        calls[name] = None
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.core import native
    native.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card '{smi}', torch {torch.__version__}", flush=True)
    rows, launches = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        for name in CONFIGS:
            config_rows, launches[name] = table_of(name, work, torch.device("cuda"))
            rows += config_rows
            torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "kernels": rows, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
