"""k5_roofline_pct: K5 (`kernels.multiband.pyramid_accumulate`, as
`pipeline.compose_fused` calls it) in the profiled stitches: the sum of its
calls' bytes bounds (`yardstick.k5_bound_ms`: the rects in, the union of
their windows in every band read and written once) over the device time
of its kernels in the trace, in percent; nothing where no call or kernel
was seen."""

from benchmark import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.k5_calls:
        return None
    device_s = ctx.trace.kernel_seconds(yardstick.K5_KERNELS)
    if device_s <= 0:
        return None
    bound_s = sum(yardstick.k5_bound_ms(shape, offs, acc_hw, nb)
                  for shape, offs, acc_hw, nb in ctx.k5_calls) / 1e3
    return 100.0 * bound_s / device_s
