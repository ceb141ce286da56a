"""The gather kernel's share of its bound by bytes over the traced training steps: each table's distinct rows read once, ids read once, the rows written once."""

from portbench import readers

LAYER = "lookup"
SOURCE = "device_trace"
MOVES = "train_examples_per_s"


def read(ctx):
    return readers.gather_share(ctx, "train")
