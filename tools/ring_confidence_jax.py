"""The JAX package's matching on features a GPU stitch handed matching,
on the CPU: does the reference zero the same adjacent pairs?

Run from the repository root, after `tools.ring_features` wrote NPZ:
    JAX_PLATFORMS=cpu python -m tools.ring_confidence_jax NPZ

For each adjacent pair (a, a + 1) of the file's image stack, runs the
JAX package's `match_pair` (`image_stitching_tpu/ops/matching.py`) with
the key its stitch gives that pair (split(PRNGKey(seed), n_pairs)[p]) and
the file's match_conf, and prints n_matches, n_inliers, n_inliers / (8 +
0.3 n_matches) and the confidence after the near-duplicate rule (> 3 ->
0), beside the GPU stitch's counts stored in the file.
"""

from __future__ import annotations

import sys

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp
    from image_stitching_tpu.config import StitchConfig
    from image_stitching_tpu.ops import matching as jm
    from image_stitching_tpu.ops.features import Features
    z = dict(np.load(sys.argv[1]))
    n = z["xy"].shape[0]
    desc = z["desc"] if z["desc"].dtype.kind == "f" else \
        z["desc"].view(np.uint32)
    zeros = np.zeros(z["valid"].shape, np.float32)
    iu, ju = np.triu_indices(n, 1)
    keys = jax.random.split(jax.random.PRNGKey(StitchConfig().seed),
                            len(iu))
    rows = []
    for a in range(n - 1):
        p = int(np.flatnonzero((iu == a) & (ju == a + 1))[0])
        fa, fb = (Features(
            xy=jnp.asarray(z["xy"][i]), response=jnp.asarray(zeros[i]),
            angle=jnp.asarray(zeros[i]),
            octave=jnp.asarray(zeros[i].astype(np.int32)),
            size=jnp.asarray(zeros[i]), desc=jnp.asarray(desc[i]),
            valid=jnp.asarray(z["valid"][i])) for i in (a, a + 1))
        pm = jm.match_pair(fa, fb, keys[p],
                           match_conf=float(z["match_conf"]))
        n_inl, n_m = int(pm.num_inliers), int(np.asarray(pm.valid).sum())
        rows.append((a, a + 1, n_m, n_inl,
                     round(n_inl / (8.0 + 0.3 * n_m), 4),
                     round(float(pm.confidence), 4)))
    print(f"{z['features']} at sigma {float(z['sigma'])}: the JAX "
          f"package's match_pair per adjacent pair (a, b, n_matches, "
          f"n_inliers, n_inliers / (8 + 0.3 n_matches), confidence): "
          f"{rows}; the GPU stitch's n_matches {z['n_matches'].tolist()}, "
          f"n_inliers {z['n_inliers'].tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
