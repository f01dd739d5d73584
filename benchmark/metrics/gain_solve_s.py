"""gain_solve_s: seconds a stitch in `gain solve` spans (the exposure
compensator's solve of its block-gain system on the host, and the
filtering of each view's gain map); nothing where the program has no such
span."""

from benchmark import spans


def read(ctx):
    traces = spans.window(ctx)
    if not traces or not any(s.name == "gain solve"
                             for t in traces for s in t.spans):
        return None
    return spans.seconds(ctx, "gain solve")
