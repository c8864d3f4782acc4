"""Fig. 10 on the port: heterogeneous server prices and non-unit item
sizes under the ``heterogeneous`` cost model (per-server lam_j / mu_j,
size-weighted transfer and rent, per-server dt_j).

    python -m repro_torch.bench.fig10 [--requests N] [--device cpu]
    python -m repro_torch.bench.fig10 --smoke [--device cpu]

The port of ``benchmarks/fig10_heterogeneous.py``: (a) server-price skew
(lognormal sigma of lam_j / mu_j) x (b) the item-size distribution, with
``no_packing``, ``packcache``, ``akpc`` and OPT at each point, the whole
grid in ONE :func:`~repro_torch.bench.common.run_method_grid` call on
``--device`` (default CUDA) at ``REPRO_BENCH_SWEEP_REQUESTS`` (default
40,000).  Every scenario prices per-server dt, so every replay step runs
the ``seg_scan_step`` kernel.  The payload lands in
``fig10_heterogeneous_torch.json`` under ``REPRO_RESULTS``.

``--smoke`` is the reference's gate: heterogeneous AKPC must beat
``no_packing`` on a small skewed scenario (100 servers, 20,000 requests,
lognormal sizes, price sigma 1.0), serial runs on ``--device``.
"""
from __future__ import annotations

import argparse
import sys

from ..core import CostParams
from ..traces import SynthConfig, synth_trace
from .common import N_SWEEP, device_arg, emit, run_method_grid, run_methods
from .common import save_json
from .sweep_bench import PRICE_SIGMAS, SIZE_DISTS, env_for, sized_trace

METHODS = ("no_packing", "packcache", "akpc", "opt")
COST_MODEL = "heterogeneous"


def grid(n_requests: int) -> tuple[list[dict], list[str]]:
    """The (size_dist x price_sigma) grid and each entry's key."""
    params = CostParams()
    out, keys = [], []
    for size_dist in SIZE_DISTS:
        tr = sized_trace(n_requests, size_dist)
        for sigma in PRICE_SIGMAS:
            out.append({"trace": tr, "params": params, "methods": METHODS,
                        "env": env_for(tr, params, sigma),
                        "cost_model": COST_MODEL})
            keys.append(f"{size_dist}/sigma={sigma}")
    return out, keys


def payload_of(n_requests: int, keys: list, results: list[dict],
               kind: str = "netflix") -> dict:
    """The reference's payload from the grid's results."""
    payload: dict = {"cost_model": COST_MODEL, "kind": kind,
                     "n_requests": n_requests, "grid": {}}
    for key, res in zip(keys, results):
        payload["grid"][key] = {
            m: {"total": v["total"], "transfer": v["transfer"],
                "caching": v["caching"]}
            for m, v in res.items()
        }
        payload["grid"][key]["akpc_vs_no_packing_saving_pct"] = round(
            100.0 * (1.0 - res["akpc"]["total"]
                     / res["no_packing"]["total"]), 2)
    return payload


def smoke_trace():
    """The gate's trace: denser per-server traffic than the grid's (100
    servers at ~2.8 requests per server per unit time), lognormal sizes."""
    return synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=100, n_requests=20_000,
        t_max=72.0, bundle_cover=1.0, bundle_zipf=0.7,
        server_affinity=2, mean_session_len=6.0, seed=0,
        size_dist="lognormal",
    ))


def smoke(device=None) -> tuple[int, dict]:
    """The gate: AKPC must beat no_packing under skewed prices and sizes.
    Returns the exit code and the two methods' results."""
    params = CostParams()
    tr = smoke_trace()
    env = env_for(tr, params, price_sigma=1.0)
    res = run_methods(tr, params, methods=("no_packing", "akpc"), env=env,
                      cost_model=COST_MODEL, device=device)
    akpc, nop = res["akpc"]["total"], res["no_packing"]["total"]
    saving = 100.0 * (1.0 - akpc / nop)
    print(f"fig10 --smoke: akpc={akpc:.0f} no_packing={nop:.0f} "
          f"saving={saving:.1f}%")
    if akpc >= nop:
        print("FAIL: heterogeneous AKPC no longer beats no_packing")
        return 1, res
    print("OK")
    return 0, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=N_SWEEP)
    device_arg(ap)
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.device)[0]
    g, keys = grid(args.requests)
    payload = payload_of(args.requests, keys,
                         run_method_grid(g, device=args.device))
    rows = []
    for key, r in payload["grid"].items():
        rows.append((
            f"fig10/{key}", 0,
            ";".join(f"{m}={round(r[m]['total'], 1)}" for m in METHODS)
            + f";akpc_saving={r['akpc_vs_no_packing_saving_pct']}%",
        ))
    save_json("fig10_heterogeneous_torch", payload)
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
