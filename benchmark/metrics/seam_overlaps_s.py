"""seam_overlaps_s: seconds a stitch in `seam overlaps` spans (the DP seam
finder's pass over every pair of views: the overlap test, the overlap's
components labelled and canonicalised into DP tasks); nothing where the
program has no such span."""

from benchmark import spans


def read(ctx):
    traces = spans.window(ctx)
    if not traces or not any(s.name == "seam overlaps"
                             for t in traces for s in t.spans):
        return None
    return spans.seconds(ctx, "seam overlaps")
