"""Fig. 5 on the port: total cost of every method against OPT on both
traces (stacked transfer / caching components).

    python -m repro_torch.bench.fig5 [--requests N] [--device cpu]

The port of ``benchmarks/fig5_cost_comparison.py``: the Fig.-5 method set
(``no_packing``, ``ttl``, ``learned``, ``dp_greedy``, ``packcache``,
``akpc_base``, ``akpc``) over the Table-II ``netflix`` and ``spotify``
traces at ``REPRO_BENCH_REQUESTS`` (default 150,000; ``--requests``
overrides it) under the paper's ``table1`` pricing, both traces in ONE
:func:`~repro_torch.bench.common.run_method_grid` call on ``--device``
(default CUDA).  Each method is reported relative to the OPT lower bound
(``rel_total``, and its transfer share ``rel_transfer``), with AKPC's
saving over ``packcache``.  The payload lands in
``fig5_cost_comparison_torch.json`` under ``REPRO_RESULTS``.
"""
from __future__ import annotations

import argparse
import sys

from ..core import CostParams
from .common import (
    N_REQUESTS,
    device_arg,
    emit,
    get_trace_shards,
    relative_to_opt,
    run_method_grid,
    save_json,
)

KINDS = ("netflix", "spotify")


def grid(n_requests: int) -> list[dict]:
    """Both traces' full method sets under the paper's table1 pricing."""
    params = CostParams()                     # Table II base values
    return [{"trace": get_trace_shards(kind, n_requests), "params": params,
             "cost_model": "table1"} for kind in KINDS]


def payload_rows(results: list[dict]) -> tuple[dict, list]:
    """The reference's payload and CSV rows from the grid's results."""
    rows, payload = [], {}
    for kind, res in zip(KINDS, results):
        rel = relative_to_opt(res)
        payload[kind] = {"raw": res, "relative": rel, "cost_model": "table1"}
        for m, v in rel.items():
            ct = res[m]["transfer"] / res["opt"]["total"]
            rows.append((f"fig5/{kind}/{m}", int(res[m]["seconds"] * 1e6),
                         f"rel_total={v};rel_transfer={round(ct, 4)}"))
        akpc_vs_pc = 1 - res["akpc"]["total"] / res["packcache"]["total"]
        rows.append((f"fig5/{kind}/akpc_vs_packcache_saving", 0,
                     f"{round(100 * akpc_vs_pc, 1)}%"))
    return payload, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=N_REQUESTS)
    device_arg(ap)
    args = ap.parse_args(argv)
    payload, rows = payload_rows(run_method_grid(grid(args.requests),
                                                 device=args.device))
    save_json("fig5_cost_comparison_torch", payload)
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
