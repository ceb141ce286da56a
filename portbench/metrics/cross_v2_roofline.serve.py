"""Every cross_v2.cu kernel of the traced calls against the bound of the cross stack's forward: 4 B d0 r L f32 operations at 495 TFLOP/s, or its bytes."""

from portbench import readers

LAYER = "cross"
SOURCE = "device_trace"
MOVES = "serve_p95_ms"


def read(ctx):
    return readers.cross_v2_share(ctx, "serve")
