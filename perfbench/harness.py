"""One run of one cell: set-up, the measured window, the check, the
result line.

With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` the same window runs under the profiler (and the
benchmark's own spans around its calls into the program) and the line
carries the cell's per-layer metrics, ``busy_s`` / ``window_s`` and the
breakdown.  Both check the window's outputs against the plain reference
once the window has closed and the program's state is freed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import check, hostinfo, readers, registry, tracing

#: top-level modules no run may hold once its window has closed: JAX and
#: the reference package the port was made from (compared whole: the
#: port's own name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: dict, bench: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> dict:
    """One run; returns the result line (``checks`` last)."""
    import torch

    cuda = device == "cuda"
    calib_before = hostinfo.calibrate()
    t0 = time.perf_counter()
    import repro_torch  # noqa: F401  (the program's import is set-up)

    drv = registry.driver(cell["traffic"]["driver"])(
        cell, seed, tracing=trace, device=device)
    drv.setup()
    setup_s = time.perf_counter() - t0
    snap0 = hostinfo.Snapshot()
    if trace:
        with tracing.LaunchRecorder() as rec, \
                tracing.Profile(cuda) as prof:
            rec.active = True
            with tracing.span(tracing.WINDOW_SPAN):
                e2e = drv.window(seconds)
            rec.active = False
    else:
        e2e = drv.window(seconds)
    host = hostinfo.window(snap0, hostinfo.Snapshot())
    host.update(calib_before_s=calib_before, calib_after_s=hostinfo.calibrate())
    counters = drv.counters()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.check()
    correct, shown = check.verdict(numbers, cell["workload"]["limits"])

    metrics = {}
    if trace:
        ctx = readers.Context(counters, prof, rec.bounds)
        for m in registry.per_layer(bench, cell["name"]):
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in registry.end_to_end(bench, cell["name"]):
            v = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["entry"]["chips"]),
           "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": int(drv.attempted),
            "failed": int(drv.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        line["breakdown"] = {"device_ops": prof.device_ops,
                             "idle_gaps": prof.idle_gaps}
    info = {k: v for k, v in counters.items()
            if not isinstance(v, np.ndarray)}
    if trace:
        from . import roofline

        info["trace_cost_s"] = prof.cost_s
        info["roofline_launches"] = {
            k: [len(rec.bounds.get(k, ())), *prof.kernel_seconds(k)]
            for k in roofline.DEVICE_NAMES}
    print("counters " + json.dumps(info, default=float), file=sys.stderr)
    print("host " + json.dumps(host), file=sys.stderr)
    line["checks"] = shown
    return line


def main(argv=None) -> int:
    args = parse(argv)
    bench = registry.benchmark()
    cell = registry.cell(args.workload, bench)
    import torch

    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, v in line["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
