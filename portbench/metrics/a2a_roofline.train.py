"""The bytes rank 0's all_to_all calls sent to other cards in the traced window (the padded [N, C] buffers less its own row), at NVLink 4's 450 GB/s a direction, over the time of its NCCL send/recv kernels, in %."""

from portbench import exchange

LAYER = "exchange"
SOURCE = "device_trace"
MOVES = "train_examples_per_s"


def read(ctx):
    return exchange.a2a_share(ctx)
