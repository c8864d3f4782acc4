"""95th percentile of the seconds from a 128-request slice's submit to the first poll that finds it settled, in ms."""
from perfbench import readers


def read(ctx):
    return readers.settle_p95_ms(ctx)
