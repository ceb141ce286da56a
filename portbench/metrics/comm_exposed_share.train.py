"""The share of rank 0's traced window in which a NCCL kernel runs and no other kernel, copy or set does, in %."""

from portbench import exchange

LAYER = "exchange"
SOURCE = "device_trace"
MOVES = "train_examples_per_s"


def read(ctx):
    return exchange.comm_exposed_share(ctx)
