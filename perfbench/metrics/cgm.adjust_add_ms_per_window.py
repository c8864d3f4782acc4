"""Seconds in the program's cgm.adjust.add span (Alg. 4's added-edge phase: its edge list's sync and its per-edge loop) a T_CG window, in ms."""


def read(ctx):
    v = ctx.span_seconds("cgm.adjust.add")
    windows = ctx.counters.get("windows", 0)
    if v is None or not windows:
        return None
    return float(v.sum()) / windows * 1e3
