"""Model FLOPs of the window's steps (forward, backward at twice it) over the window's time at 495 TFLOP/s, in %."""

from portbench import readers

LAYER = "model step"
SOURCE = "host_clock"
MOVES = "train_examples_per_s"


def read(ctx):
    return readers.mfu(ctx, "train")
