"""The program's span traces (`image_stitching_tpu_torch.core.logging`), as
the per-layer readers take them.

The program keeps each stitch's `Trace` in memory: its spans (name,
parent, start and end in ns) and counters, the last few hundred in
`recent_traces()`, the process's first in `first_trace()`.  The window's
stitches are the last `len(ctx.walls)` traces taken with the profiler off:
the stitches a `--trace 1` run profiles after the window are left out, and
the warm-up came before it.  Every function returns None where the program
keeps no traces.
"""

from __future__ import annotations

import statistics
from typing import Callable, List, Optional


def _log():
    try:
        from image_stitching_tpu_torch.core import logging as log
    except ImportError:
        return None
    return log if hasattr(log, "recent_traces") else None


def window(ctx) -> Optional[List]:
    """The window's traces, oldest first; None where they are not all
    kept."""
    log = _log()
    n = len(ctx.walls or [])
    if log is None or n == 0:
        return None
    quiet = [t for t in log.recent_traces() if not t.profiled]
    return quiet[-n:] if len(quiet) >= n else None


def first(ctx):
    """The process's first trace: the warm-up stitch."""
    log = _log()
    return None if log is None else log.first_trace()


def mean(ctx, fn: Callable) -> Optional[float]:
    """The window's mean of fn(trace)."""
    traces = window(ctx)
    if not traces:
        return None
    return statistics.fmean(fn(t) for t in traces)


def seconds(ctx, name: str) -> Optional[float]:
    """Seconds a stitch in spans called `name`."""
    return mean(ctx, lambda t: t.seconds(name))


def counter(ctx, name: str) -> Optional[float]:
    """A counter's mean a stitch (0 where a stitch did not count it)."""
    return mean(ctx, lambda t: t.counters.get(name, 0))


def untraced_pct(trace) -> float:
    """The share of the trace's root that no top-level stage covers, %."""
    root = trace.root
    wall = root.end_ns - root.start_ns
    if wall <= 0:
        return 0.0
    covered = union_ns(trace.stages(), root.start_ns, root.end_ns)
    return 100.0 * (wall - covered) / wall


def union_ns(spans, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the spans cover."""
    total, end = 0, lo
    for s in sorted(spans, key=lambda s: s.start_ns):
        a, b = max(s.start_ns, end), min(s.end_ns, hi)
        if b > a:
            total += b - a
            end = b
    return total
