"""torch.cuda.max_memory_allocated over the window, after reset_peak_memory_stats, in GiB."""

LAYER = "device"
SOURCE = "program_counter"
MOVES = "train_examples_per_s"


def read(ctx):
    return ctx.window_peak_bytes / 2**30 if ctx.kind == "train" and ctx.window_peak_bytes else None
