"""How far the SIFT, SURF and AKAZE detectors on a CUDA GPU drift from the
same modules on the CPU, over every view of the e2e ring, and whether the
stitches depend on it.

Run from the repository root on a machine with one CUDA GPU:
    python3 -m tools.detector_drift [OUT_JSON]   (default detector_drift.json)

Renders the 8 x 2448x3264 ring of `chip_smoke.py` (DEFAULT_RING, sigma 8,
and its sigma-12 twin).  For each detector it stitches DEFAULT_RING with
`chip_smoke.py`'s phase-14 configuration on the GPU, records the features
each view's detector gave (`stitcher.detect_features`), and runs the same
module on the CPU on the same gray image (a process pool, one view a
worker).  Keypoints pair by octave, 1e-2 px and 1e-3 rad, as phase 14
pairs them; the counts are per view: valid keypoints, unpaired ones, and
among the paired the descriptors that differ at all, by more than 1e-6,
1e-5 and 1e-4 (SIFT, SURF; the largest difference) or in how many bits
(AKAZE).  Then the stitch that phase 14 gates (AKAZE on DEFAULT_RING,
SIFT at 1500 features and SURF on the sigma-12 ring) is made twice on the
GPU, with the GPU's features and with the CPU's moved to the GPU: kept
indices must be equal, and the cameras' largest relative-rotation and
focal differences are reported.  Prints one line per detector and writes
the counts as JSON.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time

import numpy as np
import torch

FIELDS = ("xy", "response", "angle", "octave", "size", "desc", "valid")


def _cpu_detect(args):
    """Worker: one view's detector on the CPU, as numpy fields."""
    gray, feat, extra = args
    torch.set_num_threads(1)
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.pipeline import stitcher
    f = stitcher.detect_features(torch.from_numpy(gray),
                                 StitchConfig(features_type=feat, **extra))
    return {k: getattr(f, k).numpy() for k in FIELDS}


def compare(feat: str, cpu: dict, gpu) -> dict:
    """One view's GPU features against the CPU's: pairing as phase 14's
    `detector_vs_cpu`, then the descriptor differences of the pairs."""
    g = {k: getattr(gpu, k).cpu() for k in FIELDS}
    c = {k: torch.from_numpy(v) for k, v in cpu.items()}
    ri = torch.nonzero(c["valid"])[:, 0]
    gi = torch.nonzero(g["valid"])[:, 0]
    near = ((torch.abs(c["xy"][ri, None, 0] - g["xy"][None, gi, 0]) <= 1e-2)
            & (torch.abs(c["xy"][ri, None, 1] - g["xy"][None, gi, 1])
               <= 1e-2)
            & (c["octave"][ri, None] == g["octave"][None, gi]))
    turn = torch.remainder(c["angle"][ri, None].double()
                           - g["angle"][None, gi].double() + np.pi,
                           2 * np.pi) - np.pi
    near &= torch.abs(turn) <= 1e-3
    paired = near.any(1)
    rp = ri[paired]
    gp = gi[near.to(torch.uint8).argmax(1)][paired]
    out = dict(valid_cpu=int(c["valid"].sum()), valid_gpu=int(
        g["valid"].sum()), unpaired=int((~paired).sum()), paired=len(rp))
    if feat == "akaze":
        shifts = torch.arange(32, dtype=torch.int32)
        flips = (((c["desc"][rp][:, :, None] >> shifts)
                  ^ (g["desc"][gp][:, :, None] >> shifts)) & 1).sum((1, 2))
        out.update(moved=int((flips > 0).sum()), bit_flips=int(flips.sum()),
                   most_flips=int(flips.max()) if len(rp) else 0)
    else:
        err = torch.abs(c["desc"][rp] - g["desc"][gp]).amax(1)
        out.update(moved=int((err > 0).sum()),
                   above_1e6=int((err > 1e-6).sum()),
                   above_1e5=int((err > 1e-5).sum()),
                   above_1e4=int((err > 1e-4).sum()),
                   max_diff=float(err.max()) if len(rp) else 0.0)
    return out


def _rel_deg(ra, rb) -> float:
    m = np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(m) - 1) / 2, -1,
                                              1))))


def main() -> int:
    if not torch.cuda.is_available():
        print("detector_drift: no CUDA device", file=sys.stderr)
        return 2
    out_path = sys.argv[1] if len(sys.argv) > 1 else "detector_drift.json"
    import chip_smoke as cs
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.core.logging import Recorder
    from image_stitching_tpu_torch.kernels import _build
    from image_stitching_tpu_torch.pipeline import stitcher
    dev = torch.device("cuda")
    workers = max(1, min(8, os.cpu_count() or 1))
    smi = cs._smi()
    result = {"card": smi}
    with tempfile.TemporaryDirectory(prefix="detector_drift_") as work:
        dirs = {name: os.path.join(work, name)
                for name in ("e2e", "default", "plain", "noisy")}
        t0 = time.perf_counter()
        k_true, rs_true = cs.write_e2e_rings(dirs["e2e"], dirs["default"],
                                             dirs["plain"], workers,
                                             dirs["noisy"])
        _build.load_library()
        print(f"rings rendered and kernels built in "
              f"{time.perf_counter() - t0:.1f} s; card '{smi}'", flush=True)
        ctx = mp.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers,
                                                    mp_context=ctx) as pool:
            for feat in cs.DETECTORS:
                result[feat] = run_detector(
                    feat, cs, StitchConfig, Recorder, stitcher, dirs, pool,
                    k_true, rs_true, dev, work)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out_path}", flush=True)
    return 0


def run_detector(feat, cs, StitchConfig, Recorder, stitcher, dirs, pool,
                 k_true, rs_true, dev, work):
    """The drift counts of one detector over DEFAULT_RING's views and the
    dependence check on its phase-14 stitch."""
    conf = dict(match_conf=cs.DETECTOR_MATCH_CONF[feat])
    keep = cs.DETECTOR_KEEP[feat]
    gated = "default" if feat == "akaze" else "noisy"
    out = {}
    for ring, extra in (("default", {}), ("noisy", keep)):
        if ring == "noisy" and gated != "noisy":
            continue
        cfg = StitchConfig(features_type=feat, checkpoint_dir=work, **conf,
                           **extra)
        rec = Recorder(stitcher, "detect_features")
        try:
            with rec:
                res = stitcher.stitch(dirs[ring], cfg, output="",
                                      device=dev)
        except RuntimeError as e:
            if not str(e).startswith("Need more images"):
                raise
            res = None
        calls = rec.calls["detect_features"]
        t0 = time.perf_counter()
        cpu = list(pool.map(_cpu_detect, [
            (args[0].cpu().numpy(), feat, extra) for args, _, _ in calls]))
        cpu_s = time.perf_counter() - t0
        views = [compare(feat, c, got) for c, (_, _, got) in zip(cpu, calls)]
        total = {k: sum(v[k] for v in views) for k in views[0]
                 if k not in ("max_diff", "most_flips")}
        out[ring] = dict(views=views, total=total, cpu_s=cpu_s)
        print(f"{feat} on the {ring} ring ({len(views)} views, CPU "
              f"detectors {cpu_s:.1f} s): totals {total}; per view "
              f"moved {[v['moved'] for v in views]}, "
              + (f"bit flips {[v['bit_flips'] for v in views]}"
                 if feat == "akaze" else
                 f"max |diff| {[f'{v['max_diff']:.3g}' for v in views]}"),
              flush=True)
        if ring != gated:
            continue
        assert res is not None and res.kept_indices == list(
            range(len(calls))), "the gated stitch did not keep every view"
        it = iter(cpu)

        def cpu_features(gray, cfg_):
            f = next(it)
            return type(calls[0][2])(*(torch.from_numpy(f[k]).to(dev)
                                       for k in FIELDS))
        real = stitcher.detect_features
        stitcher.detect_features = cpu_features
        try:
            alt = stitcher.stitch(dirs[ring], cfg, output="", device=dev)
        finally:
            stitcher.detect_features = real
        a, b = res.cameras.numpy(), alt.cameras.numpy()
        n = len(res.kept_indices)
        rot = max(_rel_deg(a["R"][i + 1] @ a["R"][i].T,
                           b["R"][i + 1] @ b["R"][i].T)
                  for i in range(n - 1))
        focal = float(np.max(np.abs(a["focal"] - b["focal"]) / a["focal"]))
        hw = (cs.H, cs.W)
        err = [cs.reproj_err_px(r.cameras, r.kept_indices, k_true, rs_true,
                                r.work_scale, hw) for r in (res, alt)]
        assert alt.kept_indices == res.kept_indices, (alt.kept_indices,
                                                      res.kept_indices)
        out["stitch"] = dict(ring=ring, kept=res.kept_indices,
                             kept_equal=True, max_rel_rotation_deg=rot,
                             max_focal_rel=focal, reproj_gpu_px=err[0],
                             reproj_cpu_features_px=err[1])
        print(f"{feat} phase-14 stitch on the {ring} ring with the CPU's "
              f"features: kept {alt.kept_indices} (equal), adjacent "
              f"relative rotations within {rot:.3g} deg, focal within "
              f"{focal:.3g} (relative), reprojection {err[0]:.4f} px with "
              f"the GPU's features, {err[1]:.4f} px with the CPU's",
              flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
