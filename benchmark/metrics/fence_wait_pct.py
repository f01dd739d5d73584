"""fence_wait_pct: the `fence` spans (each stage's closing
`torch.cuda.synchronize`: the host waiting for the card) over the top-level
stages' spans, summed over the window's stitches, in percent."""

from benchmark import spans


def read(ctx):
    traces = spans.window(ctx)
    if not traces:
        return None
    fence = stage = 0.0
    for t in traces:
        for i in range(1, len(t.spans)):
            if t.spans[i].parent == 0:
                stage += t.spans[i].seconds
                fence += sum(c.seconds for c in t.children(i)
                             if c.name == "fence")
    return 100.0 * fence / stage if stage > 0 else None
