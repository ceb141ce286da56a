"""Self device ms a step of the sharded step's tfrec.exchange.lookup and tfrec.exchange.update spans (dedup, bucketing, both all_to_all exchanges, the owner's gather, receive combine and rowwise update), on rank 0."""

from portbench import exchange

LAYER = "exchange"
SOURCE = "program_span"
MOVES = "train_examples_per_s"


def read(ctx):
    return exchange.exchange_device_ms(ctx)
