"""seam_tasks: the program's `seams.tasks` counter a stitch (the DP tasks,
one a connected component of a pair's overlap, that the seam finder
cut); nothing where no stitch of the window counted it."""

from benchmark import spans


def read(ctx):
    traces = spans.window(ctx)
    if not traces or not any("seams.tasks" in t.counters for t in traces):
        return None
    return spans.counter(ctx, "seams.tasks")
