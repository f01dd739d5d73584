"""Stage logging, spans and counters (port of `core/logging.py`).

`stage_timer` mirrors the reference's LOGLN("<stage>, time: ...") lines
and adds each stage's seconds to a `StageTimes` dict.
The fence that makes a stage time honest under asynchronous CUDA launches
is `torch.cuda.synchronize` on the stage's device.

`stage_timer` is also the port's one span recorder.  Inside `trace_stitch`
each `stage_timer` and each `span` is a `Span` of the stitch's `Trace`:
its name, its parent, its start and end on `time.perf_counter_ns()` (the
monotonic clock torch's profiler reads) and a few host integers.  A stage
holds a `fence` child, the synchronize it ends with.  `count` adds to one
of the trace's counters.  Every span is also a
`torch.profiler.record_function` range of its name, so a profile puts the
device's work and idle time under the span the host was in.  Spans and
counters read host values only; outside `trace_stitch` they are ranges
alone.  Traces stay in memory: the stitch returns its own, and
`recent_traces` keeps the last `RECENT_TRACES` stitches that returned (a
stitch that raises keeps none) besides the process's first
(`first_trace`).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import logging
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("image_stitching_tpu_torch")

__all__ = ["logger", "stage_timer", "StageTimes", "Span",
           "Trace", "span", "count", "trace_stitch", "recent_traces",
           "first_trace", "RECENT_TRACES"]

# Seconds per stage name, as `StitchResult.stage_times` returns them.
StageTimes = Dict[str, float]

# Traces `recent_traces` keeps: a warm-up, a 51 s window of resumed 8-view
# rings (about 100 stitches) and the profiled stitches after it, with room.
RECENT_TRACES = 256


@dataclasses.dataclass
class Span:
    name: str
    parent: int                 # index in Trace.spans; -1 for the root
    start_ns: int               # time.perf_counter_ns()
    end_ns: int = 0
    trace_id: int = 0
    attrs: Optional[Dict[str, int]] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Trace:
    """One stitch's spans, in the order they opened (the root first), and
    its counters.  `profiled`: torch's profiler was on when it began."""
    trace_id: int
    profiled: bool
    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    _open: List[int] = dataclasses.field(default_factory=list, repr=False)

    @property
    def root(self) -> Span:
        return self.spans[0]

    def children(self, index: int) -> List[Span]:
        return [s for s in self.spans if s.parent == index]

    def stages(self) -> List[Span]:
        """The top-level stages: the root's children."""
        return self.children(0)

    def seconds(self, name: str) -> float:
        """Summed seconds of the spans called `name`."""
        return sum(s.seconds for s in self.spans if s.name == name)


_ACTIVE: contextvars.ContextVar[Optional[Trace]] = contextvars.ContextVar(
    "image_stitching_tpu_torch_trace", default=None)
_IDS = itertools.count(1)
_RECENT: collections.deque = collections.deque(maxlen=RECENT_TRACES)
_FIRST: List[Trace] = []


class span:
    """`with span(name, **ints):` a span of the active trace under the
    innermost open one, and a `record_function` range of `name`."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_range", "_trace",
                 "_record")

    def __init__(self, name: str, **attrs: int):
        self.name = name
        self.attrs = attrs or None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        trace = self._trace = _ACTIVE.get()
        self.start_ns = time.perf_counter_ns()
        if trace is not None:
            self._record = Span(self.name,
                                trace._open[-1] if trace._open else -1,
                                self.start_ns, trace_id=trace.trace_id,
                                attrs=self.attrs)
            trace._open.append(len(trace.spans))
            trace.spans.append(self._record)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._trace is not None:
            self._record.end_ns = self.end_ns
            self._trace._open.pop()
        self._range.__exit__(None, None, None)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def count(name: str, n: int = 1) -> None:
    """Add n to the active trace's counter `name` (nothing outside one)."""
    trace = _ACTIVE.get()
    if trace is not None:
        trace.counters[name] = trace.counters.get(name, 0) + int(n)


@contextlib.contextmanager
def trace_stitch():
    """Open a new trace with its root span `stitch` for the block, and
    yield it.  On a normal exit it joins `recent_traces` (the process's
    first is kept as `first_trace` too); a block that raises leaves none."""
    trace = Trace(next(_IDS), bool(torch._C._autograd._profiler_enabled()))
    token = _ACTIVE.set(trace)
    try:
        with span("stitch"):
            yield trace
    finally:
        _ACTIVE.reset(token)
    if not _FIRST:
        _FIRST.append(trace)
    _RECENT.append(trace)


def recent_traces() -> List[Trace]:
    """The traces of the last `RECENT_TRACES` stitches that returned,
    oldest first."""
    return list(_RECENT)


def first_trace() -> Optional[Trace]:
    """The process's first stitch that returned (its warm-up)."""
    return _FIRST[0] if _FIRST else None


@contextlib.contextmanager
def stage_timer(name: str, times: Optional[StageTimes] = None,
                device: Optional[torch.device] = None):
    """Time a pipeline stage; synchronises `device` at its end when it is
    CUDA, in the stage's `fence` child.  The stage, fence included, is a
    span and so a `record_function` range, so a profile can attribute
    launches and device time to stages."""
    stage = span(name)
    stage.__enter__()
    try:
        yield
    finally:
        with span("fence"):
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
        stage.__exit__(None, None, None)
        elapsed = stage.seconds
        if times is not None:
            times[name] = times.get(name, 0.0) + elapsed
        logger.info("%s, time: %.6g sec", name, elapsed)
