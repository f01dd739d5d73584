"""Stage logging and wall-clock timing (port of `core/logging.py`).

`stage_timer` mirrors the reference's LOGLN("<stage>, time: ...") lines.
The fence that makes a stage time honest under asynchronous CUDA launches
is `torch.cuda.synchronize` on the stage's device.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger("image_stitching_tpu_torch")

__all__ = ["logger", "stage_timer"]


@contextlib.contextmanager
def stage_timer(name: str, times: Optional[Dict[str, float]] = None,
                device: Optional[torch.device] = None):
    """Time a pipeline stage; synchronises `device` first when it is CUDA."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - start
        if times is not None:
            times[name] = times.get(name, 0.0) + elapsed
        logger.info("%s, time: %.6g sec", name, elapsed)
