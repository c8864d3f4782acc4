"""Fig. 6 on the port: sensitivity to (a) the discount factor alpha and
(b) the cost ratio rho = lambda / mu.

    python -m repro_torch.bench.fig6 [--requests N] [--device cpu]

The port of ``benchmarks/fig6_sensitivity.py``: the whole (trace x alpha
+ trace x rho) grid of ``no_packing``, ``packcache``, ``akpc`` and OPT over
the Table-II ``netflix`` and ``spotify`` traces at
``REPRO_BENCH_SWEEP_REQUESTS`` (default 40,000; ``--requests`` overrides
it) goes through ONE :func:`~repro_torch.bench.common.run_method_grid`
call on ``--device`` (default CUDA): alpha never enters the clique
generation, so the alpha axis shares one schedule per (trace, method),
and each cohort of schedules replays as the lanes of one scan.  Each
point is reported relative to OPT; the payload lands in
``fig6_sensitivity_torch.json`` under ``REPRO_RESULTS``.
"""
from __future__ import annotations

import argparse
import sys

from ..core import CostParams
from .common import (
    N_SWEEP,
    device_arg,
    emit,
    get_trace_shards,
    relative_to_opt,
    run_method_grid,
    save_json,
)

ALPHAS = [0.6, 0.7, 0.8, 0.85, 0.9, 1.0]
RHOS = [1.0, 2.0, 4.0, 6.0, 10.0]
METHODS = ("no_packing", "packcache", "akpc", "opt")
KINDS = ("netflix", "spotify")


def grid(n_requests: int) -> tuple[list[dict], list[tuple]]:
    """The (trace x alpha + trace x rho) grid and each entry's
    ``(axis, kind, value)`` key."""
    out, keys = [], []
    for kind in KINDS:
        tr = get_trace_shards(kind, n_requests)
        for a in ALPHAS:
            out.append({"trace": tr, "params": CostParams(alpha=a),
                        "methods": METHODS, "cost_model": "table1"})
            keys.append(("alpha", kind, a))
        for r in RHOS:
            out.append({"trace": tr, "params": CostParams(rho=r),
                        "methods": METHODS, "cost_model": "table1"})
            keys.append(("rho", kind, r))
    return out, keys


def payload_rows(keys: list, results: list[dict]) -> tuple[dict, list]:
    """The reference's payload and CSV rows from the grid's results."""
    rows, payload = [], {"alpha": {}, "rho": {}, "cost_model": "table1"}
    for (axis, kind, val), res in zip(keys, results):
        rel = relative_to_opt(res)
        payload[axis].setdefault(kind, {})[val] = rel
        tag = "fig6a" if axis == "alpha" else "fig6b"
        rows.append((f"{tag}/{kind}/{axis}={val}", 0,
                     ";".join(f"{m}={rel[m]}" for m in METHODS)))
    return payload, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=N_SWEEP)
    device_arg(ap)
    args = ap.parse_args(argv)
    g, keys = grid(args.requests)
    stats: dict = {}
    payload, rows = payload_rows(
        keys, run_method_grid(g, device=args.device, stats=stats))
    save_json("fig6_sensitivity_torch", payload)
    emit(rows)
    print(f"# {len(g)} grid entries, {stats['schedules']} schedules, "
          f"{len(stats['groups'])} scans, {stats['wall']:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
