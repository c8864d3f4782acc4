"""Seconds in the program's host_cgm.upload span (the hooks' host-to-device copies) a T_CG window, in ms."""


def read(ctx):
    v = ctx.span_seconds("host_cgm.upload")
    windows = ctx.counters.get("windows", 0)
    if v is None or not windows:
        return None
    return float(v.sum()) / windows * 1e3
