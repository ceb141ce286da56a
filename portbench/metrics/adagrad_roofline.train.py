"""The fused rowwise-Adagrad kernel's share of its bound over the traced steps: each distinct row and its accumulator read and written once, its combined gradient and every id read once."""

from portbench import readers

LAYER = "sparse update"
SOURCE = "device_trace"
MOVES = "train_examples_per_s"


def read(ctx):
    return readers.adagrad_share(ctx, "train")
