"""The gather kernel's share of its bound by bytes over the traced calls: each table's distinct rows of a call read once, ids read once, the rows written once."""

from portbench import readers

LAYER = "lookup"
SOURCE = "device_trace"
MOVES = "serve_p95_ms"


def read(ctx):
    return readers.gather_share(ctx, "serve")
