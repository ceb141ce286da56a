"""Every cross_v2.cu kernel of the traced training steps against the bound of the cross stack's forward and backward: 12 B d0 r L f32 operations at 495 TFLOP/s, or its bytes."""

from portbench import readers

LAYER = "cross"
SOURCE = "device_trace"
MOVES = "train_examples_per_s"


def read(ctx):
    return readers.cross_v2_share(ctx, "train")
