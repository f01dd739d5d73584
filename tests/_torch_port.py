"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from fixed seeds and go through the JAX
reference on the CPU (as its own tests run it) and through the port on CPU
tensors.  torch gets one thread: the suite runs under several xdist
workers, and torch's default thread count would oversubscribe the cores.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def t(a, dtype=None):
    """numpy (or jax) array -> CPU torch tensor (a copy)."""
    arr = np.array(a, copy=True)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.as_tensor(arr, dtype=dtype)


def n(x):
    """torch tensor or array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cuda_device():
    """The CUDA device for tests marked `cuda`; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def rel_rotation_deg(ra, rb) -> float:
    """Angle (degrees) of ra @ rb^T."""
    m = np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T
    return float(np.degrees(np.arccos(np.clip((np.trace(m) - 1) / 2,
                                              -1.0, 1.0))))
