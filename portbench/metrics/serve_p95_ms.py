"""The 95th percentile of every call's latency in the window, from the call to its logits on the host."""

from portbench import readers

SOURCE = "host_clock"


def read(ctx):
    return readers.percentile_ms(ctx.latency_s, 95) if ctx.kind == "serve" else None
