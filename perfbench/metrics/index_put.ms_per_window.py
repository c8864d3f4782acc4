"""Device ms of index_put's accumulate kernel (indexing_backward_kernel) a T_CG window."""
from perfbench import readers


def read(ctx):
    return readers.index_put_ms_per_window(ctx)
