"""upload_mib: the program's `ingest.upload_bytes` counter a stitch (the
decoded bytes ingest copies to the card), in MiB."""

from benchmark import spans


def read(ctx):
    value = spans.counter(ctx, "ingest.upload_bytes")
    return None if value is None else value / 2 ** 20
