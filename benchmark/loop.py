"""The one traffic generator: capture sets from the seed, a closed loop of
one client over them, and the judgement of what the loop returned.

A traffic mix is a data file, `traffic/<name>.json`, whose keys a cell's
`workloads/<cell>.json` may override under `params`:

- `sets`: capture sets the window cycles through (set 0, rendered besides,
  is the warm-up's), so consecutive stitches never read the same files;
  each set has its own scene and noise;
- `resume`: false registers every set afresh; true resumes each from a
  checkpoint (`cams.data`, `indices.data`) the benchmark writes from the
  set's ground-truth cameras (`serialize_data=False`: no features,
  matching or bundle adjustment);
- `profile_stitches`: in a `--trace 1` run, the stitches profiled after
  the window closes.

The client hands `stitch()` a capture directory and waits for the
panorama; the next stitch starts when it returns.  Through the run the
program's exposure feeds and seam finder (`stitcher.feed_device`,
`stitcher.feed`, `stitcher.find_seams`) are wrapped to keep each stitch's
fitted gains, warped masks and seam masks, which the judgement reads for
the sampled stitches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

import numpy as np
import torch

from . import reference, scene


@dataclasses.dataclass
class Record:
    """One stitch of the window: its set, wall, and what it returned."""
    set_index: int
    wall_s: float
    kept: List[int]
    cameras: object             # the program's Cameras (tensors)
    work_scale: float
    stage_times: Dict[str, float]


@dataclasses.dataclass
class Window:
    records: List[Record]
    window_s: float
    failed: int
    # One sampled (panorama, mask, Record, layers) per set, drawn from the
    # seed; layers is what `layer_recorder` kept of that stitch.
    sampled: Dict[int, tuple]


def stitch_config(config: Dict, params: Dict, directory: str):
    """The cell's `StitchConfig`: the configuration's fields, with the
    checkpoint in `directory` and, to resume, serialize_data=False."""
    from image_stitching_tpu_torch.config import StitchConfig
    fields = dict(config["stitch_config"], checkpoint_dir=directory)
    if params["resume"]:
        fields["serialize_data"] = False
    return StitchConfig(**fields)


def prepare(config: Dict, params: Dict, seed: int, workdir: str, device):
    """Render sets 0..`sets` under workdir (set 0 is the warm-up's) and, to
    resume, write each set's checkpoint.  Returns [(CaptureSet,
    StitchConfig)]."""
    capture = config["capture"]
    if params["resume"] and config["stitch_config"].get(
            "work_megapix", -1.0) > 0:
        raise ValueError("a resumed cell needs work_megapix < 0 (the "
                         "checkpoint is written at full resolution)")
    out = []
    futures = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for s, (tex_seed, noise_seed) in enumerate(
                scene.set_seeds(seed, params["sets"] + 1)):
            d = os.path.join(workdir, f"set{s}")
            cset, fut = scene.make_capture_set(
                os.path.join(d, "captures"), capture, tex_seed, noise_seed,
                device, pool)
            futures += fut
            ckpt = os.path.join(d, "checkpoint")
            os.makedirs(ckpt, exist_ok=True)
            if params["resume"]:
                scene.write_checkpoint(ckpt, cset.k, cset.rs,
                                       range(cset.n_images))
            out.append((cset, stitch_config(config, params, ckpt)))
        for f in futures:
            f.result()
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def layer_recorder():
    """Wrap the program's `stitcher.feed_device`, `stitcher.feed` and
    `stitcher.find_seams`, passing everything on unchanged, so that the
    yielded dict holds the last stitch's "gains" (the fitted compensator)
    and "seams" (corners, warped masks, seam masks; host arrays)."""
    from image_stitching_tpu_torch.pipeline import stitcher
    names = ("feed_device", "feed", "find_seams")
    saved = {k: getattr(stitcher, k) for k in names}
    holder: Dict[str, object] = {"gains": None, "seams": None}

    def fed(fit):
        def run(*args, **kw):
            holder["gains"] = fit(*args, **kw)
            return holder["gains"]
        return run

    def seams(corners, masks, *args, **kw):
        out = saved["find_seams"](corners, masks, *args, **kw)
        holder["seams"] = ([tuple(int(v) for v in c) for c in corners],
                           [np.asarray(m) for m in masks], out)
        return out
    stitcher.feed_device = fed(saved["feed_device"])
    stitcher.feed = fed(saved["feed"])
    stitcher.find_seams = seams
    try:
        yield holder
    finally:
        for k, v in saved.items():
            setattr(stitcher, k, v)


def run_window(stitch: Callable, sets, seconds: float, output: str,
               seed: int, device, min_stitches: int = 0) -> Window:
    """Stitch sets 1..n in turn until `seconds` have passed since the
    start (and at least `min_stitches` were started); every stitch started
    inside counts, and the window ends when the last returns.  A stitch
    that raises counts as failed."""
    with layer_recorder() as layers:
        return _run_window(stitch, sets, seconds, output, seed, device,
                           min_stitches, layers)


def _run_window(stitch, sets, seconds, output, seed, device, min_stitches,
                layers) -> Window:
    rng = random.Random(seed)
    records, sampled, seen = [], {}, {}
    failed = 0
    t_start = time.perf_counter()
    i = 0
    t_end = t_start
    while time.perf_counter() - t_start < seconds or i < min_stitches:
        s = 1 + i % (len(sets) - 1)
        cset, cfg = sets[s]
        layers["gains"] = layers["seams"] = None
        t0 = time.perf_counter()
        try:
            res = stitch(cset.directory, cfg, output=output, device=device)
            sync(device)
        except (RuntimeError, ValueError):
            failed += 1
            res = None
        t_end = time.perf_counter()
        if res is not None:
            records.append(Record(s, t_end - t0, list(res.kept_indices),
                                  res.cameras, res.work_scale,
                                  dict(res.stage_times)))
            # A reservoir of one per set keeps a uniform sample.
            seen[s] = seen.get(s, 0) + 1
            if rng.random() < 1.0 / seen[s]:
                sampled[s] = (res.panorama, res.mask, records[-1],
                              dict(layers))
        del res
        i += 1
    return Window(records, t_end - t_start, failed, sampled)


def judge(window: Window, sets, config: Dict, control: bool = False,
          ) -> Dict[str, float]:
    """The numbers compared, each the worst over the run: reproj_px over
    every stitch's cameras; dropped_pct, the share of the stitches' input
    views that they left out; canvas_px, mask_xor_pct and pano_mae over
    the sampled panoramas; exposure_left_pct over their fitted gains and
    seam_overlap_pct over their seam masks.  With `control`, the
    reference computed in bfloat16 (the precision below the
    configuration's float32) takes the program's place: the true cameras
    rounded to bfloat16 for each stitch's cameras, and the expected
    panorama computed in bfloat16 for its panorama; the reference keeps
    every view and has no gains or seam masks, so it reads 0 on those
    three."""
    pair_angle = config.get("pair_angle_deg")
    reproj = 0.0
    views = dropped = 0
    for rec in window.records:
        cset = sets[rec.set_index][0]
        cams = (true_cameras(cset, rec.kept, rec.work_scale, torch.bfloat16)
                if control else rec.cameras.numpy())
        err = reference.registration_error(cams, rec.kept, rec.work_scale,
                                           cset, pair_angle)
        reproj = max(reproj, err if np.isfinite(err) else float("inf"))
        views += cset.n_images
        dropped += 0 if control else cset.n_images - len(set(rec.kept))
    out = {"reproj_px": reproj,
           "dropped_pct": 100.0 * dropped / views if views else 0.0,
           "canvas_px": 0.0, "mask_xor_pct": 0.0, "pano_mae": 0.0,
           "exposure_left_pct": 0.0, "seam_overlap_pct": 0.0}
    for s, (pano, mask, rec, layers) in window.sampled.items():
        cams = rec.cameras.numpy()
        cset, cfg = sets[s]
        expected, emask, geometry = reference.expected_panorama(
            cams, rec.kept, rec.work_scale, cset, cfg.compose_megapix)
        if control:
            pano, mask, _ = reference.expected_panorama(
                cams, rec.kept, rec.work_scale, cset, cfg.compose_megapix,
                dtype=torch.bfloat16)
        for name, value in reference.compare(pano, mask, expected, emask,
                                             geometry).items():
            out[name] = max(out[name], value)
        if control:
            continue
        seams, comp = layers["seams"], layers["gains"]
        if seams is None or comp is None:
            out["exposure_left_pct"] = out["seam_overlap_pct"] = 100.0
            continue
        corners, warped, seam_masks = seams
        out["exposure_left_pct"] = max(
            out["exposure_left_pct"], reference.exposure_left_pct(
                corners, warped, comp.gains, comp.grid_sizes,
                cset.gains[list(rec.kept)]))
        out["seam_overlap_pct"] = max(
            out["seam_overlap_pct"],
            reference.seam_overlap_pct(corners, seam_masks))
    return out


def true_cameras(cset, kept, work_scale: float, dtype) -> Dict[str,
                                                               np.ndarray]:
    """The kept views' ground-truth cameras at work scale, rounded to
    `dtype`, in the fields `Cameras.numpy()` gives."""
    n = len(kept)

    def rnd(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype).double(
        ).numpy()
    k = cset.k * work_scale
    return {"focal": rnd(np.full(n, k[1, 1])), "aspect": rnd(np.ones(n)),
            "ppx": rnd(np.full(n, k[0, 2])), "ppy": rnd(np.full(n, k[1, 2])),
            "R": rnd(cset.rs[list(kept)]), "t": np.zeros((n, 3))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            attempted: int, failed: int) -> bool:
    """True when something was stitched, nothing failed, and every number
    is within its limit."""
    return (attempted > 0 and failed == 0
            and all(numbers[k] <= limits[k] for k in limits))


def render_check(numbers: Dict[str, float], limits: Dict[str, float],
                 ) -> Dict[str, Dict[str, float]]:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def kept_counts(records: List[Record]) -> Dict[int, List[int]]:
    """The distinct kept-view counts of each set's stitches."""
    out: Dict[int, List[int]] = {}
    for rec in records:
        out.setdefault(rec.set_index, [])
        n = len(rec.kept)
        if n not in out[rec.set_index]:
            out[rec.set_index].append(n)
    return {s: sorted(v) for s, v in out.items()}
