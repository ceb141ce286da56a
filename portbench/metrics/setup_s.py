"""Process start to the first timed step or call: imports, the kernels' build on a checkout's first run, tables and weights, the traffic pool, the first steps and warm-up."""

SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
