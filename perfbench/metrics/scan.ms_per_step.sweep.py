"""Seconds in the program's host.scan span a scan step of the sweep, in ms."""
from perfbench import readers


def read(ctx):
    return readers.span_ms_per_step(ctx, "host.scan")
