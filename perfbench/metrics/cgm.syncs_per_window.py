"""The device clique generation's host syncs (loop_stats sync_*) a T_CG window."""
from perfbench import readers


def read(ctx):
    return readers.cgm_syncs_per_window(ctx)
