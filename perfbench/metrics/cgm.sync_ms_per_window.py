"""Seconds in the program's cgm.sync.<kind> spans (the device clique generation's host syncs) a T_CG window, in ms."""


def read(ctx):
    spans = [v for k, v in ctx.profile.spans.items()
             if k.startswith("cgm.sync.") and v.size]
    windows = ctx.counters.get("windows", 0)
    if not spans or not windows:
        return None
    return float(sum(v.sum() for v in spans)) / windows * 1e3
