"""decode_wait_s: seconds a stitch the host waits in `decode wait` spans
(`FastIngest.upload` blocked on the native decode of one item)."""

from benchmark import spans


def read(ctx):
    return spans.seconds(ctx, "decode wait")
