"""untraced_pct: the share of a stitch's root span (`stitch`, the whole of
the stitch's body) that no top-level stage covers, in percent, the
window's mean."""

from benchmark import spans


def read(ctx):
    return spans.mean(ctx, spans.untraced_pct)
