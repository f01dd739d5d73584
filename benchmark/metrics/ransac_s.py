"""ransac_s: seconds a stitch in `ransac block` spans (one chunk of pairs
through the ratio test and RANSAC, its threefry draws included)."""

from benchmark import spans


def read(ctx):
    return spans.seconds(ctx, "ransac block")
