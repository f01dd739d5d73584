"""seam_dp_s: seconds a stitch in `dp batch` spans (one batched dynamic
program of the DP seam finder per bucket of task shapes: the crops
gathered on the device, the row-by-row accumulation, the backtrack on the
host); nothing where the program has no such span."""

from benchmark import spans


def read(ctx):
    traces = spans.window(ctx)
    if not traces or not any(s.name == "dp batch"
                             for t in traces for s in t.spans):
        return None
    return spans.seconds(ctx, "dp batch")
