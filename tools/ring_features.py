"""The default configuration's full-resolution features and adjacent
match counts on the e2e ring, on one CUDA GPU.

Run from the repository root:
    python3 -m tools.ring_features OUT_NPZ [SIGMA] [FEATURES]
                                       (default sigma 4, features orb)

Renders the 8 x 2448x3264 ring of `data/synth.py` (E2E_RING) with the
given sensor-noise sigma, stitches it with StitchConfig(fast_ingest=False,
features_type=FEATURES) (4000 features at full resolution; match_conf
0.65 for sift and surf, the CLI's rule) on the GPU, and prints the kept
indices (or the stitch's error) and, per adjacent pair, n_matches,
n_inliers and n_inliers / (8 + 0.3 n_matches) before the near-duplicate
rule (> 3 -> confidence 0).  Writes the features matching was given (xy,
desc, valid) and those counts to OUT_NPZ: the ORB file at sigma 4 is the
input of `tests/test_torch_matching.py`'s full-resolution matching parity
tests; `python -m tools.ring_confidence_jax OUT_NPZ` runs the JAX
package's matching on any of them on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_features: no CUDA device", file=sys.stderr)
        return 2
    from image_stitching_tpu_torch.config import StitchConfig
    from image_stitching_tpu_torch.core.logging import Recorder
    from image_stitching_tpu_torch.data.synth import E2E_RING, write_ring_dir
    from image_stitching_tpu_torch.pipeline import stitcher
    out = sys.argv[1]
    sigma = float(sys.argv[2]) if len(sys.argv) > 2 else 4.0
    features = sys.argv[3] if len(sys.argv) > 3 else "orb"
    n = E2E_RING["n_images"]
    cfg = StitchConfig(fast_ingest=False, features_type=features,
                       match_conf=0.65 if features in ("sift", "surf")
                       else 0.32)
    with tempfile.TemporaryDirectory(prefix="ring_features_") as work:
        caps = os.path.join(work, "caps")
        write_ring_dir(caps, **E2E_RING, noise_sigma=sigma)
        with Recorder(stitcher, "match_all_pairs") as rec:
            try:
                kept = stitcher.stitch(
                    caps, dataclasses.replace(cfg, checkpoint_dir=work),
                    output="", device="cuda").kept_indices
            except RuntimeError as e:
                kept = str(e)
    (feats, *_), _, graph = rec.calls["match_all_pairs"][0]
    inl = graph.num_inliers.cpu().numpy()
    nm = graph.num_matches.cpu().numpy()
    a = np.arange(n - 1)
    n_inliers, n_matches = inl[a, a + 1], nm[a, a + 1]
    raw = n_inliers / (8.0 + 0.3 * n_matches.astype(np.float32))
    np.savez_compressed(
        out, sigma=sigma, features=features, match_conf=cfg.match_conf,
        xy=feats.xy.cpu().numpy(), desc=feats.desc.cpu().numpy(),
        valid=feats.valid.cpu().numpy(), n_inliers=n_inliers,
        n_matches=n_matches, kept=np.asarray(kept))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"sigma {sigma}, {features}: kept {kept}; adjacent pairs' "
          f"n_matches {n_matches.tolist()}, n_inliers "
          f"{n_inliers.tolist()}, n_inliers / (8 + 0.3 n_matches) "
          f"{raw.tolist()}; features {tuple(feats.desc.shape)} -> {out}; "
          f"card '{smi}'", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
