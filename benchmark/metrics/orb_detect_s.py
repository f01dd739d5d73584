"""orb_detect_s: seconds a stitch in `orb level` spans (ORB's detection of
one pyramid level of one view: resize, FAST, Harris, NMS, top-k, blur)."""

from benchmark import spans


def read(ctx):
    return spans.seconds(ctx, "orb level")
