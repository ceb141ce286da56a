"""Self device ms a step of tfrec.bag_pool, the forward's pooling of the multi-hot bags into one embedding a field, on rank 0."""

from portbench import exchange

LAYER = "bag pool"
SOURCE = "program_span"
MOVES = "train_examples_per_s"


def read(ctx):
    return exchange.bag_pool_device_ms(ctx)
