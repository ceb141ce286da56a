"""Examples of every step completed in the window over the window's time, closed by a torch.cuda.synchronize()."""

SOURCE = "host_clock"


def read(ctx):
    return ctx.units * ctx.rows_per_unit / ctx.window_s if ctx.kind == "train" else None
