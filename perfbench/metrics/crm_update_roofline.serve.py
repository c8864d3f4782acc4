"""crm_update's share of its bound in the served stream, in percent."""
from perfbench import readers


def read(ctx):
    return readers.roofline(ctx, "crm_update")
