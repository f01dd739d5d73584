"""launches_per_stitch: the host's kernel-launch calls (profiler events
named *LaunchKernel*) in the profiled stitches, per stitch."""


def read(ctx):
    if ctx.trace is None or ctx.trace.n_stitches == 0:
        return None
    return ctx.trace.launches / ctx.trace.n_stitches
