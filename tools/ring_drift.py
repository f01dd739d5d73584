"""Where the port's stitch of DEFAULT_RING on a CUDA GPU parts from the JAX
package's stitch on the CPU, stage by stage.

Run from the repository root on the GPU machine (it has jax; the tools
may import it, the port never does):
    JAX_PLATFORMS=cpu python3 -m tools.ring_drift

Renders DEFAULT_RING (8 x 2448x3264, sigma-8 noise) as `chip_smoke.py`
does, then stitches it under `StitchConfig()` four or five ways, each
recording its ORB features, its match graph, the cameras bundle
adjustment returned and those wave correction returned: the JAX package
on the CPU (the reference; its fast ingest on the port's build of the
native runtime, as `tools/ring_reference_jax.py` runs it), the port on
the CPU, the port on the GPU, and the port on the GPU with the features
replaced by the port's CPU features and by the JAX package's.  For each
port run against the reference it prints: the features (keypoints at
equal xy, descriptors equal among them), each pair's n_inliers
difference, the focal's largest relative difference and the largest
angle between adjacent relative rotations, after bundle adjustment and
after wave correction, in both forms: R[a+1] R[a]^T (world frame, as
the e2e tests and smoke phase 9b compare them) and R[a]^T R[a+1] (camera
frame, gauge-free, what the reprojection error sees); and each run's
mean reprojection error against the ground truth.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch


def _angle(m1, m2, precise=True) -> float:
    """Angle (degrees) of m1 m2^T: by `chip_smoke.rel_rotation_deg`, or
    (precise=False) by arccos((tr - 1) / 2), as the smoke and the tests
    took it before, which reads float32 rotations' 1e-7 scale error as up
    to ~0.04 degree."""
    if precise:
        from chip_smoke import rel_rotation_deg
        return rel_rotation_deg(m1, m2)
    m = np.asarray(m1, np.float64) @ np.asarray(m2, np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(m) - 1) / 2,
                                              -1.0, 1.0))))


def _rel(r, world: bool):
    r = np.asarray(r, np.float64)
    return [r[a + 1] @ r[a].T if world else r[a].T @ r[a + 1]
            for a in range(len(r) - 1)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _Cams:
    """Camera fields as `chip_smoke.reproj_err_px` reads them."""

    def __init__(self, d):
        self.d = d

    def numpy(self):
        return self.d


def _record(mod, names, store):
    """Wrap mod.<name> so each call's result is appended to store[name];
    returns a function that puts the originals back."""
    real = {name: getattr(mod, name) for name in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            store.setdefault(name, []).append(out)
            return out
        return call
    for name, fn in real.items():
        setattr(mod, name, wrap(name, fn))
    return lambda: [setattr(mod, n, f) for n, f in real.items()]


def _to_cuda(feats):
    """The port's Features with every field moved to the GPU."""
    return dataclasses.replace(feats, **{
        f.name: getattr(feats, f.name).to("cuda")
        for f in dataclasses.fields(feats)})


def _cams(c) -> dict:
    """Camera fields as float64 numpy, from either package's Cameras."""
    return {k: np.asarray(_np(getattr(c, k)), np.float64)
            for k in ("focal", "aspect", "ppx", "ppy", "R")}


def run_jax(caps):
    from image_stitching_tpu.config import StitchConfig
    from image_stitching_tpu.ops.features import orb as jorb
    from image_stitching_tpu.pipeline import stitcher
    store = {}
    undo = [_record(jorb, ["orb_detect_stack"], store),
            _record(stitcher, ["match_all_pairs", "bundle_adjust",
                               "wave_correct"], store)]
    try:
        res = stitcher.stitch(caps, StitchConfig(), output="")
    finally:
        for u in undo:
            u()
    f = store["orb_detect_stack"][0]
    g = store["match_all_pairs"][0]
    return dict(
        kept=list(res.kept_indices),
        feats={k: _np(getattr(f, k)) for k in ("xy", "desc", "valid")},
        features=f,
        ninl=_np(g.num_inliers), ii=_np(g.ii), jj=_np(g.jj),
        ba=_cams(store["bundle_adjust"][0]),
        final=_cams(res.cameras))


def run_port(caps, device, feats=None):
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.pipeline import stitcher
    store = {}
    undo = _record(stitcher, ["detect_stack", "match_all_pairs",
                              "bundle_adjust"], store)
    real_detect = stitcher.detect_stack
    if feats is not None:
        stitcher.detect_stack = lambda grays, cfg: feats
    try:
        res = stitcher.stitch(caps, StitchConfig(), output="", device=device)
    finally:
        undo()
        stitcher.detect_stack = real_detect
    f = feats if feats is not None else store["detect_stack"][0]
    g = store["match_all_pairs"][0]
    return dict(
        kept=list(res.kept_indices),
        feats={k: _np(getattr(f, k)) for k in ("xy", "desc", "valid")},
        features=f, ninl=_np(g.num_inliers), ii=_np(g.ii), jj=_np(g.jj),
        ba=_cams(store["bundle_adjust"][0]), final=_cams(res.cameras))


def compare(name, run, ref, k_true, rs_true, hw, reproj):
    same_xy = np.all(run["feats"]["xy"] == ref["feats"]["xy"], axis=-1) & \
        run["feats"]["valid"] & ref["feats"]["valid"]
    desc_eq = np.all(run["feats"]["desc"].view(np.uint32) ==
                     ref["feats"]["desc"].view(np.uint32), axis=-1)
    ninl = [int(run["ninl"][i, j]) - int(ref["ninl"][i, j])
            for i, j in zip(ref["ii"], ref["jj"])]
    parts = []
    for stage in ("ba", "final"):
        a, b = run[stage], ref[stage]
        focal = float(np.max(np.abs(a["focal"] - b["focal"]) / b["focal"]))
        world, cam, arccos = (
            max(_angle(x, y, precise) for x, y in zip(_rel(a["R"], w),
                                                      _rel(b["R"], w)))
            for w, precise in ((True, True), (False, True), (True, False)))
        parts.append(f"{stage}: focal {focal:.3g}, rotations world "
                     f"{world:.4f} deg (by arccos {arccos:.4f}), camera "
                     f"frame {cam:.4f} deg")
    err = reproj(_Cams(run["final"]), run["kept"], k_true, rs_true, 1.0,
                 hw)
    print(f"{name} vs the JAX stitch: kept {run['kept']} "
          f"({'equal' if run['kept'] == ref['kept'] else 'DIFFERENT'}); "
          f"keypoints at equal xy {int(same_xy.sum())} of "
          f"{int(ref['feats']['valid'].sum())}, descriptors equal among "
          f"them {int((same_xy & desc_eq).sum())}; n_inliers - reference "
          f"{ninl}; " + "; ".join(parts) +
          f"; reprojection vs ground truth {err:.4f} px", flush=True)


def main() -> int:
    import chip_smoke as cs
    from image_stitching_tpu_torch.data.synth import (DEFAULT_RING,
                                                      write_ring_dir)
    from image_stitching_tpu_torch.interop import features_from_numpy
    from tools.ring_reference_jax import _native_runtime
    print(f"native runtime: {_native_runtime()}", flush=True)
    cuda = torch.cuda.is_available()
    with tempfile.TemporaryDirectory(prefix="ring_drift_") as work:
        caps = os.path.join(work, "caps")
        k_true, rs_true = write_ring_dir(caps, **DEFAULT_RING)
        hw = tuple(DEFAULT_RING["hw"])
        os.chdir(work)
        runs = {}
        for name, fn in (
                ("JAX on the CPU", lambda: run_jax(caps)),
                ("port on the CPU", lambda: run_port(caps, "cpu")),
                ("port on the GPU", lambda: run_port(caps, "cuda")),
                ("port on the GPU, the port's CPU features", lambda: run_port(
                    caps, "cuda",
                    _to_cuda(runs["port on the CPU"]["features"]))),
                ("port on the GPU, the JAX features", lambda: run_port(
                    caps, "cuda", features_from_numpy(
                        runs["JAX on the CPU"]["features"], device="cuda")))):
            if "GPU" in name and not cuda:
                continue
            t0 = time.perf_counter()
            runs[name] = fn()
            print(f"{name}: stitched in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        ref = runs["JAX on the CPU"]
        err = cs.reproj_err_px(_Cams(ref["final"]), ref["kept"], k_true,
                               rs_true, 1.0, hw)
        print(f"JAX on the CPU: kept {ref['kept']}, reprojection vs ground "
              f"truth {err:.4f} px", flush=True)
        for name, run in runs.items():
            if run is not ref:
                compare(name, run, ref, k_true, rs_true, hw,
                        cs.reproj_err_px)
        if cuda:
            print(f"card '{cs._smi()}'", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
