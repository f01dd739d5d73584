"""ransac_k7_pairs: the program's `ransac.k7_pairs` counter a stitch (the
pairs whose RANSAC hypotheses kernel K7 scored on the card); nothing where
no stitch of the window counted it."""

from benchmark import spans


def read(ctx):
    traces = spans.window(ctx)
    if not traces or not any("ransac.k7_pairs" in t.counters
                             for t in traces):
        return None
    return spans.counter(ctx, "ransac.k7_pairs")
