"""The share of the traced window in which no kernel, copy or fill ran on the card, in percent."""
from perfbench import readers


def read(ctx):
    return readers.device_idle(ctx)
