"""Stage logging and wall-clock timing (port of `core/logging.py`).

`stage_timer` mirrors the reference's LOGLN("<stage>, time: ...") lines
and adds each stage's seconds to a `StageTimes` dict.
The fence that makes a stage time honest under asynchronous CUDA launches
is `torch.cuda.synchronize` on the stage's device.  `Recorder` keeps the
calls of chosen module functions, for diagnostics that need what one stage
handed the next.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger("image_stitching_tpu_torch")

__all__ = ["logger", "stage_timer", "StageTimes", "Recorder"]

# Seconds per stage name, as `StitchResult.stage_times` returns them.
StageTimes = Dict[str, float]


@contextlib.contextmanager
def stage_timer(name: str, times: Optional[StageTimes] = None,
                device: Optional[torch.device] = None):
    """Time a pipeline stage; synchronises `device` first when it is CUDA.
    The stage, fence included, is also a `record_function` range, so a
    profile can attribute launches and device time to stages."""
    start = time.perf_counter()
    span = torch.profiler.record_function(name)
    span.__enter__()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        span.__exit__(None, None, None)
        elapsed = time.perf_counter() - start
        if times is not None:
            times[name] = times.get(name, 0.0) + elapsed
        logger.info("%s, time: %.6g sec", name, elapsed)


class Recorder:
    """Pass-through wrappers on module attributes that keep each call's
    (args, kwargs, result), by reference, in `calls[name]` while the
    context is open."""

    def __init__(self, module, *names):
        self.module = module
        self.orig = {name: getattr(module, name) for name in names}
        self.calls = {name: [] for name in names}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.module, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls[name].append((args, kwargs, out))
            return out
        return rec

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)
