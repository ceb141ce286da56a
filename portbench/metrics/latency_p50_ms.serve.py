"""The median latency of the window's calls, from each call to its logits on the host."""

from portbench import readers

LAYER = "serving entry"
SOURCE = "host_clock"
MOVES = "serve_p95_ms"


def read(ctx):
    return readers.percentile_ms(ctx.latency_s, 50) if ctx.kind == "serve" else None
