"""The share of the traced window in which no kernel, copy or set runs on the card, over training steps."""

from portbench import readers

LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_examples_per_s"


def read(ctx):
    return readers.idle_share(ctx, "train")
