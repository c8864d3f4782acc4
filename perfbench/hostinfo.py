"""What the host did around a run's window, for standard error only.

The process's CPU seconds against the wall clock, its page faults and
context switches, the machine's steal share (the seconds its virtual
CPUs waited for the hypervisor, from ``/proc/stat``), and the seconds of
a fixed calibration loop before set-up and after the window.  They say
why two runs of the same work took different times; no metric reads
them.
"""
from __future__ import annotations

import resource
import time

import numpy as np


def calibrate() -> float:
    """Seconds of a fixed pure-Python and numpy loop (about 0.1 s on an
    idle core): a slower host reads longer."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i * i % 7
    a = np.arange(1 << 20, dtype=np.float64)
    for _ in range(10):
        a = np.sqrt(a * 1.0001 + 1.0)
    return time.perf_counter() - t0


def _cpu_ticks() -> list[int] | None:
    """The machine's CPU ticks by kind: user, nice, system, idle,
    iowait, irq, softirq, steal."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


class Snapshot:
    def __init__(self):
        self.wall = time.perf_counter()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        self.ticks = _cpu_ticks()


def window(a: Snapshot, b: Snapshot) -> dict:
    """What happened between two snapshots."""
    wall = b.wall - a.wall
    out = {
        "wall_s": wall,
        "user_s": b.ru.ru_utime - a.ru.ru_utime,
        "sys_s": b.ru.ru_stime - a.ru.ru_stime,
        "minor_faults": b.ru.ru_minflt - a.ru.ru_minflt,
        "ctx_voluntary": b.ru.ru_nvcsw - a.ru.ru_nvcsw,
        "ctx_involuntary": b.ru.ru_nivcsw - a.ru.ru_nivcsw,
    }
    if a.ticks and b.ticks:
        d = [y - x for x, y in zip(a.ticks, b.ticks)]
        total = sum(d) or 1
        out["machine_busy_share"] = 1.0 - (d[3] + d[4]) / total
        out["machine_steal_share"] = d[7] / total if len(d) > 7 else None
    return out
