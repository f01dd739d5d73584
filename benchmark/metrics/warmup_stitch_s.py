"""warmup_stitch_s: the root span of the process's first stitch (the
warm-up, where every kernel and shape is first met), in seconds."""

from benchmark import spans


def read(ctx):
    trace = spans.first(ctx)
    return None if trace is None else trace.root.seconds
