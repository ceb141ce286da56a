"""Model FLOPs of the window's calls over the window's time at 495 TFLOP/s, in %."""

from portbench import readers

LAYER = "model step"
SOURCE = "host_clock"
MOVES = "serve_p95_ms"


def read(ctx):
    return readers.mfu(ctx, "serve")
