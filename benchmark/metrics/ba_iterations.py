"""ba_iterations: the program's `ba.iterations` counter a stitch (passes of
the Levenberg-Marquardt loop that evaluate a step, accepted or not)."""

from benchmark import spans


def read(ctx):
    return spans.counter(ctx, "ba.iterations")
