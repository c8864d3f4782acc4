"""The mean of the program's live.build span (a chunk's schedule build, up to its first launch), in ms."""
from perfbench import readers


def read(ctx):
    return readers.span_mean_ms(ctx, "live.build")
