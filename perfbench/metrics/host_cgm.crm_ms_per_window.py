"""Seconds in the program's host_cgm.window_crm span (Alg. 2, the window's CRM) a T_CG window, in ms."""


def read(ctx):
    v = ctx.span_seconds("host_cgm.window_crm")
    windows = ctx.counters.get("windows", 0)
    if v is None or not windows:
        return None
    return float(v.sum()) / windows * 1e3
