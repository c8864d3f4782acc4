"""Seconds in the program's host.schedule span a million requests of each schedule built."""
from perfbench import readers


def read(ctx):
    return readers.span_s_per_mreq(ctx, "host.schedule", per_schedule=True)
