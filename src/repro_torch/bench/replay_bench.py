"""Replay throughput of the device replay on the 1M-request synthetic
trace, batch 4,096 against batch 1.

    python -m repro_torch.bench.replay_bench [--device cpu]
    python -m repro_torch.bench.replay_bench --smoke [--device cpu]

The port of ``benchmarks/replay_bench.py``.  The Table-II ``netflix``
trace replays on ``--device`` (default CUDA) under the table1 cost model
from a static offline pair partition (``greedy_pair_matching``, installed
at time 0, no clique generation), so the benchmark times the replay scan
alone.  The reference races its host numpy engine's scalar path against
its batched one; the port has no host numpy engine to race, so its
yardstick is the same device replay one request a step (batch 1), the
per-request path every batch size must equal:

* cost for cost on a head of the trace (``min(100,000, n, cap)``
  requests): batch 1 against batch 4,096, float fields at 1e-9, integer
  counters exact;
* throughput: batch 1 timed on that head and scaled to the trace, batch
  4,096 on the whole trace; requests per second are printed.

Env knobs (the reference's): ``REPRO_REPLAY_REQUESTS`` (default
1,000,000), ``REPRO_REPLAY_BATCH`` (4,096) and ``REPRO_REPLAY_SCALAR_CAP``
(the batch-1 head's cap; default 100,000 here, where the reference's is
the whole trace: one step a request on the card is launch-bound).  The
full run asserts a >= 5x batched speedup.  ``--smoke``: 60,000 requests,
a 20,000-request head, the equality check only.  The payload lands in
``replay_bench_torch.json`` under ``REPRO_RESULTS``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..core import CacheEnvironment, CostParams, greedy_pair_matching
from ..core.replay import TorchReplayEngine, resolve_device
from ..traces import paper_trace
from .common import device_arg, emit, save_json

COST_MODEL = "table1"
EQ_HEAD = 100_000


def replay(trace, part, batch_size: int, device=None):
    """One replay of ``trace`` from ``part`` at ``batch_size``: its costs
    and wall seconds (the state's upload, the scan, the read back)."""
    env = CacheEnvironment.from_trace(trace, CostParams())
    eng = TorchReplayEngine(trace.n, trace.m, env=env, cost_model=COST_MODEL,
                            device=device)
    eng.install_partition(part, now=0.0)
    t0 = time.perf_counter()
    eng.replay(trace, batch_size=batch_size)
    return eng.costs, time.perf_counter() - t0


def equal_costs(a, b) -> dict:
    """Float fields at 1e-9, integer counters exact; returns the floats."""
    out = {}
    for f in ("transfer", "caching", "keepalive_rent"):
        x, y = getattr(a, f), getattr(b, f)
        if not np.isclose(x, y, rtol=1e-9, atol=1e-9):
            raise AssertionError(f"{f}: batch 1 {x} != batched {y}")
        out[f] = x
    for f in ("n_misses", "n_hits", "n_requests", "items_transferred"):
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{f}: batch 1 {getattr(a, f)} != batched "
                                 f"{getattr(b, f)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small run: the cost-equality check only")
    device_arg(ap)
    args = ap.parse_args(argv)
    env = os.environ.get
    n = int(env("REPRO_REPLAY_REQUESTS",
                "60000" if args.smoke else "1000000"))
    bs = int(env("REPRO_REPLAY_BATCH", "4096"))
    cap = int(env("REPRO_REPLAY_SCALAR_CAP",
                  "20000" if args.smoke else "100000"))

    trace = paper_trace("netflix", n_requests=n, seed=0)
    part = greedy_pair_matching(trace.items, trace.n, 0.2, 1.0)

    head = trace.head(min(EQ_HEAD, n, cap))
    c_1, t_1 = replay(head, part, 1, args.device)
    c_b, _ = replay(head, part, bs, args.device)
    eq_fields = equal_costs(c_1, c_b)
    print(f"# equality check on {head.n_requests} requests: OK")

    replay(trace, part, bs, args.device)            # warm-up
    costs_b, t_batched = replay(trace, part, bs, args.device)
    t_1_full = t_1 * (n / head.n_requests)
    speedup = t_1_full / t_batched
    rps_1 = head.n_requests / t_1
    rps_b = n / t_batched
    emit([
        ("replay/batch1", int(t_1_full / n * 1e6 * 1e3) / 1e3,
         f"{rps_1:.0f} req/s"),
        (f"replay/batched_{bs}", int(t_batched / n * 1e6 * 1e3) / 1e3,
         f"{rps_b:.0f} req/s"),
        ("replay/speedup", round(speedup, 1), "x"),
    ])
    save_json("replay_bench_torch", {
        "cost_model": COST_MODEL,
        "device": str(resolve_device(args.device)),
        "n_requests": n,
        "batch_size": bs,
        "batch1_seconds": t_1_full,
        "batch1_measured_requests": head.n_requests,
        "batched_seconds": t_batched,
        "speedup": speedup,
        "requests_per_second_batch1": rps_1,
        "requests_per_second_batched": rps_b,
        "equality_head": eq_fields,
        "total_cost": costs_b.total,
    })
    if not args.smoke and speedup < 5.0:
        print(f"FAIL: batched replay only {speedup:.1f}x faster")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
