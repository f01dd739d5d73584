"""PyTorch/CUDA port of the panorama stitcher (one slice of the JAX package).

`image_stitching_tpu_torch` mirrors the module tree of `image_stitching_tpu`
so that every port module's reference is found by path.  It imports
`torch` and never `jax`; the JAX package stays the reference the tests hold
this one against.  The five TPU kernels (ORB sampling, the compose warp
gather, Hamming 2-NN, the multiband pyramid accumulate) are hand-written
CUDA kernels under `csrc/`, built with `nvcc` for `sm_90a` at first use
(`kernels/_build.py`); the host codec runtime `native/stitch_runtime.cpp`
is built with `g++` against vendored headers when needed
(`core/native.py`).  `python -m image_stitching_tpu_torch <dir>` is the
command line (`cli.py`).
"""

import torch

# Counterpart of jax_default_matmul_precision="highest" in the JAX package:
# full float32 in matrix products and convolutions (TF32 keeps ~3 digits).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import StitchConfig  # noqa: E402
from .pipeline.stitcher import stitch  # noqa: E402

__all__ = ["StitchConfig", "stitch"]
