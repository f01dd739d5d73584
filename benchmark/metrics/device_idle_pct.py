"""device_idle_pct: 100 minus the union of the device's spans (kernels,
copies, sets) over the wall of the profiled stitches, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
