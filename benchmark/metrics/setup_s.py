"""setup_s: seconds from the start of the process to the start of the
window: imports, the kernel library and native runtime (built in the
checkout on a cell's first run), rendering and writing the capture sets,
and the warm-up stitch."""


def read(ctx):
    return ctx.setup_s
