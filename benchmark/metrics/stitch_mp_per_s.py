"""stitch_mp_per_s: the input megapixels of every stitch of the window,
each of its views counted whether kept or not, over the window's time (its
start to the return of the last stitch started inside it)."""


def read(ctx):
    if not ctx.walls or ctx.window_s <= 0:
        return None
    return ctx.megapixels / ctx.window_s
