"""Candidate rows scored in the window over the window's time."""

SOURCE = "host_clock"


def read(ctx):
    return ctx.units * ctx.rows_per_unit / ctx.window_s if ctx.kind == "serve" else None
