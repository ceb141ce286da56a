"""The share of the traced window in which no kernel, copy or set runs on the card, over calls back to back."""

from portbench import readers

LAYER = "device"
SOURCE = "device_trace"
MOVES = "serve_p95_ms"


def read(ctx):
    return readers.idle_share(ctx, "serve")
