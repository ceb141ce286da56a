"""One card's model FLOPs on a mesh (its B / cards rows a step, the backward at twice the forward) over rank 0's window at 495 TFLOP/s, in %."""

from portbench import exchange

LAYER = "model step"
SOURCE = "host_clock"
MOVES = "train_examples_per_s"


def read(ctx):
    return exchange.mfu_per_card(ctx)
