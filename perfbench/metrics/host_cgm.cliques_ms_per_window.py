"""Seconds in the program's host_cgm.cliques span (Algs. 4 and 3, the cliques) a T_CG window, in ms."""


def read(ctx):
    v = ctx.span_seconds("host_cgm.cliques")
    windows = ctx.counters.get("windows", 0)
    if v is None or not windows:
        return None
    return float(v.sum()) / windows * 1e3
