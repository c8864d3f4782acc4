"""The host clique generation's seconds (the policy's cg_seconds) a T_CG window, in ms."""
from perfbench import readers


def read(ctx):
    return readers.host_cgm_ms_per_window(ctx)
