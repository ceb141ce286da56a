"""One card's cross_v2.cu kernels on a mesh against the bound of its share of the cross stack: 12 (B / cards) d0 r L f32 operations a step at 495 TFLOP/s, or its bytes (rank 0's trace)."""

from portbench import exchange

LAYER = "cross"
SOURCE = "device_trace"
MOVES = "train_examples_per_s"


def read(ctx):
    return exchange.cross_v2_share_per_card(ctx)
