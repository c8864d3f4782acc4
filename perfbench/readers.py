"""What the per-layer readers (``metrics/<name>.py``) read, and the
arithmetic they share.  A reader that finds nothing to read returns None
and the harness leaves its metric out of the line."""
from __future__ import annotations

import sys

import numpy as np


class Context:
    """A traced run: the driver's counters, the reduced profile and the
    bound seconds of each roofline kernel's launches."""

    def __init__(self, counters: dict, profile, launch_bounds: dict):
        self.counters = counters
        self.profile = profile
        self.launch_bounds = launch_bounds

    def span_seconds(self, name: str) -> np.ndarray | None:
        v = self.profile.spans.get(name)
        return None if v is None or v.size == 0 else v


def settle_p95_ms(ctx: Context):
    s = np.asarray(ctx.counters.get("settle_s", ()))
    return None if s.size < 20 else float(np.percentile(s, 95) * 1e3)


def span_s_per_mreq(ctx: Context, span: str, per_schedule: bool = False):
    v = ctx.span_seconds(span)
    req = ctx.counters.get("schedule_requests" if per_schedule
                           else "requests", 0)
    return None if v is None or not req else float(v.sum() / (req / 1e6))


def host_cgm_ms_per_window(ctx: Context):
    c = ctx.counters
    if c.get("path") != "host_schedule" or not c.get("windows"):
        return None
    return c["cg_seconds"] / c["windows"] * 1e3


def cgm_syncs_per_window(ctx: Context):
    c = ctx.counters
    if c.get("path") != "device_cgm" or not c.get("windows"):
        return None
    syncs = sum(v for k, v in c.get("loop_stats", {}).items()
                if k.startswith("sync_"))
    return syncs / c["windows"]


def span_mean_ms(ctx: Context, span: str):
    v = ctx.span_seconds(span)
    return None if v is None else float(v.mean() * 1e3)


def span_ms_per_step(ctx: Context, span: str):
    v = ctx.span_seconds(span)
    steps = ctx.counters.get("steps", 0)
    return None if v is None or not steps else float(v.sum() / steps * 1e3)


def roofline(ctx: Context, kernel: str):
    """The kernel's share of its bound: the least seconds its launches'
    inputs need over its device seconds in the trace, in percent."""
    bounds = ctx.launch_bounds.get(kernel) or []
    t, n = ctx.profile.kernel_seconds(kernel)
    if not bounds or n == 0 or t <= 0.0:
        return None
    if n != len(bounds):
        print(f"perfbench: {kernel}: {n} device launches in the trace, "
              f"{len(bounds)} calls recorded; share not read", file=sys.stderr)
        return None
    return 100.0 * float(np.sum(bounds)) / t


def device_seconds(ctx: Context, match) -> float:
    """Summed device seconds of the trace's operations whose name
    ``match`` accepts."""
    return float(sum(v for k, v in ctx.profile.device_time.items()
                     if match(k)))


def pageable_upload_s_per_mreq(ctx: Context, per_schedule: bool = False):
    """Device seconds of host-to-device copies from pageable memory (the
    host blocks on each while it is staged) a million requests."""
    t = device_seconds(ctx, lambda k: k.startswith("Memcpy HtoD (Pageable"))
    req = ctx.counters.get("schedule_requests" if per_schedule
                           else "requests", 0)
    return None if t <= 0.0 or not req else t / (req / 1e6)


def index_put_ms_per_window(ctx: Context):
    """Device ms of index_put's accumulate kernel a T_CG window."""
    c = ctx.counters
    t = device_seconds(ctx, lambda k: "indexing_backward_kernel" in k)
    if t <= 0.0 or not c.get("windows"):
        return None
    return t / c["windows"] * 1e3


def device_idle(ctx: Context):
    p = ctx.profile
    if p.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
