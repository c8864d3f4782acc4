"""The mean of the program's cgm.boundary span, in ms."""
from perfbench import readers


def read(ctx):
    return readers.span_mean_ms(ctx, "cgm.boundary")
