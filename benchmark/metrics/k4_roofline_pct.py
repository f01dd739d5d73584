"""k4_roofline_pct: K4 (`kernels.hamming.hamming_two_nn_pairs`, as
`ops.matching` calls it) in the profiled stitches: the sum of its calls'
bounds (`yardstick.k4_bound`, from the shapes and valid rows the
benchmark's wrapper recorded) over the device time of its kernels in the
trace, in percent; nothing where no call or kernel was seen."""

from benchmark import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.k4_calls:
        return None
    device_s = ctx.trace.kernel_seconds(yardstick.K4_KERNELS)
    if device_s <= 0:
        return None
    bound_s = sum(yardstick.k4_bound(k, words, valid.sum(-1).tolist(),
                                     ii.tolist(), jj.tolist())["bound_ms"]
                  for k, words, valid, ii, jj in ctx.k4_calls) / 1e3
    return 100.0 * bound_s / device_s
