"""The host's time inside a step call of the window, mean a step, with no synchronize."""

LAYER = "step entry"
SOURCE = "host_clock"
MOVES = "train_examples_per_s"


def read(ctx):
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s) if ctx.kind == "train" and ctx.enqueue_s else None
