"""Seconds in the program's host.lookup span (the host schedule's item -> clique lookups) a million requests served."""
from perfbench import readers


def read(ctx):
    return readers.span_s_per_mreq(ctx, "host.lookup")
