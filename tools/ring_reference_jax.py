"""The JAX package's stitch of DEFAULT_RING under `StitchConfig()`, on the
CPU, recorded for `tests/test_torch_card_e2e.py`'s `default` case to hold
the port's card stitch to.

Run from the repository root on a machine with jax (the tools may import
it; the port never does):
    JAX_PLATFORMS=cpu python -m tools.ring_reference_jax [OUT_JSON]

Writes DEFAULT_RING (8 x 2448x3264, sigma-8 noise) with the port's
`data/synth.py::write_ring_dir`, the files that card case renders, then
runs `image_stitching_tpu.pipeline.stitcher.stitch` on them with
exactly `StitchConfig()` (fast ingest, 4000 ORB features at full
resolution) in a scratch working directory, and records into OUT_JSON
(default `tests/data/ring_reference_jax.json`): the jax version and its
`jax_threefry_partitionable`, the SHA-256 of each capture file, the kept
indices, the match graph's n_inliers and n_matches of every pair i < j,
each kept camera's focal, aspect, principal point and R at the work
scale, the work scale, the panorama's shape and the stage seconds.

The reference's fast ingest needs the native runtime
(`native/libstitch_runtime.so`); on a machine without the system libjpeg
and libpng, where `make -C native` fails, the JAX package would take its
legacy decode instead.  So when that file is absent, the port's build of
the same unchanged source (`image_stitching_tpu_torch/core/native.py`,
against Pillow's codec libraries) is copied there first, and the run
refuses to go on unless the JAX package loads it.  On 8 CPU cores the
render takes ~40 s and the stitch ~40 s.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "ring_reference_jax.json")


def _native_runtime() -> str:
    """The runtime the JAX package will load: the tracked build if it is
    there, else the port's build copied into its place."""
    tracked = os.path.join(ROOT, "native", "libstitch_runtime.so")
    if os.path.exists(tracked):
        return "native/libstitch_runtime.so (present)"
    from image_stitching_tpu_torch.core import native as port_native
    port_native.load()
    shutil.copy(port_native.runtime_info()["path"], tracked)
    return (f"native/libstitch_runtime.so copied from the port's build "
            f"{os.path.basename(port_native.runtime_info()['path'])}")


def main() -> int:
    out_path = sys.argv[1] if len(sys.argv) > 1 else OUT
    runtime = _native_runtime()
    import jax
    from image_stitching_tpu.config import StitchConfig
    from image_stitching_tpu.core import native as jnative
    from image_stitching_tpu.pipeline import stitcher
    from image_stitching_tpu_torch.data.synth import (DEFAULT_RING,
                                                      write_ring_dir)
    assert jnative.lib is not None, "the JAX package loads no native runtime"
    assert jax.config.jax_threefry_partitionable, \
        "jax draws with the original threefry counters"
    graphs = []
    real = stitcher.match_all_pairs

    def recording(*args, **kwargs):
        graphs.append(real(*args, **kwargs))
        return graphs[-1]
    with tempfile.TemporaryDirectory(prefix="ring_reference_") as work:
        caps = os.path.join(work, "caps")
        t0 = time.perf_counter()
        write_ring_dir(caps, **DEFAULT_RING)
        render_s = time.perf_counter() - t0
        files = sorted(os.listdir(caps))
        sha = {name: hashlib.sha256(open(os.path.join(caps, name), "rb")
                                    .read()).hexdigest() for name in files}
        cwd = os.getcwd()
        os.chdir(work)                 # StitchConfig()'s checkpoints: "."
        stitcher.match_all_pairs = recording
        try:
            t0 = time.perf_counter()
            res = stitcher.stitch(caps, StitchConfig(), output="")
            wall = time.perf_counter() - t0
        finally:
            stitcher.match_all_pairs = real
            os.chdir(cwd)
    graph, = graphs
    iu, ju = np.asarray(graph.ii), np.asarray(graph.jj)
    cams = res.cameras
    record = dict(
        what="image_stitching_tpu stitch(DEFAULT_RING, StitchConfig()) on "
             "the CPU (tools/ring_reference_jax.py)",
        jax=jax.__version__, jax_threefry_partitionable=True,
        platform=jax.devices()[0].platform, native_runtime=runtime,
        ring=dict(DEFAULT_RING), seed=StitchConfig().seed,
        capture_sha256=sha, kept_indices=[int(i) for i in res.kept_indices],
        pairs=[[int(i), int(j)] for i, j in zip(iu, ju)],
        num_inliers=[int(np.asarray(graph.num_inliers)[i, j])
                     for i, j in zip(iu, ju)],
        num_matches=[int(np.asarray(graph.num_matches)[i, j])
                     for i, j in zip(iu, ju)],
        work_scale=float(res.work_scale),
        focal=np.asarray(cams.focal, np.float64).tolist(),
        aspect=np.asarray(cams.aspect, np.float64).tolist(),
        ppx=np.asarray(cams.ppx, np.float64).tolist(),
        ppy=np.asarray(cams.ppy, np.float64).tolist(),
        R=np.asarray(cams.R, np.float64).tolist(),
        panorama_shape=list(np.asarray(res.panorama).shape),
        stage_seconds={k: float(v) for k, v in res.stage_times.items()},
        wall_seconds=wall, render_seconds=render_s,
        host_cpus=os.cpu_count())
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    adjacent = [record["num_inliers"][p]
                for p, (i, j) in enumerate(record["pairs"]) if j == i + 1]
    print(f"ring_reference_jax: jax {jax.__version__} on "
          f"{record['platform']}, kept {record['kept_indices']}, focal "
          f"{[round(x, 3) for x in record['focal']]}, adjacent n_inliers "
          f"{adjacent}, "
          f"stitch {wall:.1f} s (render {render_s:.1f} s) on "
          f"{os.cpu_count()} CPUs; {runtime}; wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
