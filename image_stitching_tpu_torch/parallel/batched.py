"""Batched pair registration over the ``dp`` devices of a mesh (port of
`parallel/batched.py`).

B pairs are split into equal parts over the mesh's dp axis.  On each
device its 2b images go through ORB (`orb_detect_stack`, one K1 launch per
image), one K4 call (`hamming_two_nn_pairs`) takes the 2-NN of its b pairs
in both directions, and `match_pairs` runs the ratio test and RANSAC on
them.  The devices run one after another from the host and the results
are gathered on the first dp device.

Each pair takes its threefry key (B, 2), as in the reference
(`core/prng.py`): its RANSAC draws are the reference's, one draw for a
device's whole part of the batch, and a pair draws the same numbers in
any batch, on any mesh, or alone (`ops/matching.py::register_pair` with
that key).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.prng import check_key
from ..kernels.hamming import hamming_two_nn_pairs
from ..ops.features.orb import orb_detect_stack
from ..ops.matching import match_pairs
from .mesh import Mesh, on_device, shard_batch

__all__ = ["register_pairs_batched", "make_batched_register"]


def _register_chunk(pairs: torch.Tensor, keys: torch.Tensor, n_features: int,
                    match_conf: float, n_hyp: int):
    """Register the (b, 2, H, W) pairs of one device."""
    b = pairs.shape[0]
    dev = pairs.device
    feats = orb_detect_stack(pairs.reshape((2 * b,) + pairs.shape[2:]),
                             n_features)
    ii = torch.arange(0, 2 * b, 2, dtype=torch.int32, device=dev)
    nn = hamming_two_nn_pairs(feats.desc, feats.valid, ii, ii + 1)
    out = match_pairs(feats[ii.long()], feats[ii.long() + 1], match_conf,
                      keys.to(dev), n_hyp, nn=nn)
    return out[4], out[6], out[5]


def make_batched_register(mesh: Mesh, hw: Tuple[int, int],
                          n_features: int = 1024, match_conf: float = 0.32,
                          n_hyp: int = 512):
    """Build the dp-split batched pair registration.  Returns
    fn(pairs (B, 2, H, W) float32 gray, keys (B, 2) the pairs' threefry
    keys) ->
    (h (B, 3, 3), confidence (B,), n_inliers (B,)) on the first dp device.
    B must divide by the dp axis size."""
    sharding = shard_batch(mesh, "dp")

    def fn(pairs, keys):
        pairs = torch.as_tensor(pairs)
        if tuple(pairs.shape[2:]) != tuple(hw):
            raise ValueError(f"pairs of {tuple(pairs.shape[2:])}, built for "
                             f"{tuple(hw)}")
        check_key(keys, pairs.shape[:1])
        parts = sharding.shard(pairs)
        key_parts = keys.chunk(len(parts))
        outs = []
        for p, k in zip(parts, key_parts):
            with on_device(p.device):
                outs.append(_register_chunk(p, k, n_features, match_conf,
                                            n_hyp))
        first = parts[0].device
        return tuple(torch.cat([o[i].to(first) for o in outs])
                     for i in range(3))
    return fn


def register_pairs_batched(pairs, keys, mesh: Mesh, **kw):
    """Build and run `make_batched_register` once."""
    pairs = torch.as_tensor(pairs)
    fn = make_batched_register(mesh, (pairs.shape[2], pairs.shape[3]), **kw)
    return fn(pairs, keys)
