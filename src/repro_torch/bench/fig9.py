"""Fig. 9 on the port: (a) the clique-size distribution of the AKPC
variants, (b) the clique-generation wall time against the number of data
items (up to 10,000), and the device clique generation against the host
one.

    python -m repro_torch.bench.fig9 [--requests N] [--device cpu]
    python -m repro_torch.bench.fig9 --smoke [--device cpu]

The port of ``benchmarks/fig9_cliques_runtime.py``, on ``--device``
(default CUDA):

* (a) ``akpc``, ``akpc_no_acm`` and ``akpc_base`` over the Table-II
  ``netflix`` and ``spotify`` traces at ``REPRO_BENCH_SWEEP_REQUESTS``
  (default 40,000), one ``run_policy`` each: the histogram (sizes 0-10)
  and mean of the clique sizes over every window;
* (b) one clique-generation event (a 20,000-request window over n items,
  the top 10% of the catalog mined) as the port runs it: the CRM and the
  pair densities through the ``crm_update`` / ``clique_pair_edges``
  kernels on CUDA (``kernels/autowire.py::default_cgm_hooks``), the numpy
  paths on the CPU; best of 5.  Beside it, the same event through the
  port's copy of the scalar oracle (``core/cliques_ref.py``) on the same
  machine, the yardstick (the reference's pre-vectorization constants
  were timed on another machine and are not carried);
* ``bench_cgm``: a windowed AKPC replay (``spotify``, 8,000 requests, 20
  servers, top_frac 0.5) with the clique generation on the device
  (``core/cgm.py``) against the host clique generation whose hooks are the
  same kernels on the card (an ``AKPCConfig`` with explicit
  ``crm_matmul`` / ``pair_edges`` from ``cgm_hooks(device)``, which the
  device route refuses), warm times; both must give the same costs.

``--smoke`` runs (b) at 1,000 and 4,000 items only and fails when the
port's clique generation is not faster than the scalar oracle on the same
machine.  The payload lands in ``fig9_cliques_runtime_torch.json`` and the
``bench_cgm`` rows in ``BENCH_cgm_torch.json`` under ``REPRO_RESULTS``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import CostParams, get_policy, run_policy
from ..core import cliques_ref
from ..core.cliques import generate_cliques
from ..core.crm import build_window_crm
from ..core.replay import resolve_device
from ..kernels.autowire import cgm_hooks, default_cgm_hooks
from ..traces import SynthConfig, synth_trace
from .common import (
    N_SWEEP,
    device_arg,
    emit,
    get_trace,
    save_json,
    t_cg_for,
)
from .sweep_bench import same_costs

RUNTIME_ITEMS = [100, 1000, 4000, 10000]
SMOKE_ITEMS = [1000, 4000]
#: catalog sizes of the device-against-host clique generation rows
DEVICE_CGM_ITEMS = [64, 1000, 4000]
VARIANTS = ("akpc", "akpc_no_acm", "akpc_base")
KINDS = ("netflix", "spotify")


def runtime_trace(n: int):
    return synth_trace(SynthConfig(
        kind="spotify", n_items=n, n_servers=100, n_requests=20000,
        t_max=20.0, bundle_cover=1.0, bundle_zipf=0.7, seed=0))


def time_clique_gen(n: int, device, reps: int = 5) -> tuple[float, int]:
    """One clique-generation event over a 20,000-request window on n
    items as the port runs it on ``device``: best of ``reps`` seconds, and
    the cliques of two or more items.  ``top_frac_of="catalog"`` is the
    reference's hot-set rule for this figure."""
    tr = runtime_trace(n)
    mm, pe = default_cgm_hooks(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        crm = build_window_crm(tr.items, n, theta=0.2, top_frac=0.1,
                               crm_matmul=mm, top_frac_of="catalog")
        part = generate_cliques(None, None, crm, n, omega=5, gamma=0.85,
                                pair_edges=pe)
        best = min(best, time.perf_counter() - t0)
    return best, sum(1 for c in part.cliques if len(c) > 1)


def time_clique_gen_oracle(n: int) -> float:
    """Seconds of the same event through the scalar oracle (one pass)."""
    tr = runtime_trace(n)
    t0 = time.perf_counter()
    crm = build_window_crm(tr.items, n, theta=0.2, top_frac=0.1,
                           top_frac_of="catalog")
    cliques_ref.generate_cliques(None, None, crm, n, omega=5, gamma=0.85)
    return time.perf_counter() - t0


def size_dist(n_requests: int, device) -> tuple[dict, list]:
    """(a): ``{kind: {variant: {hist, mean}}}`` and the CSV rows."""
    params = CostParams()
    dist, rows = {}, []
    for kind in KINDS:
        tr = get_trace(kind, n_requests)
        t_cg = t_cg_for(tr, params)
        for name in VARIANTS:
            res = run_policy(get_policy(name, params=params, t_cg=t_cg,
                                        top_frac=1.0), tr, device=device)
            sizes = (np.concatenate(res.size_history) if res.size_history
                     else np.array([]))
            hist = (np.bincount(sizes.astype(int), minlength=11)[:11].tolist()
                    if sizes.size else [])
            mean = float(sizes.mean()) if sizes.size else 0.0
            dist.setdefault(kind, {})[name] = {"hist": hist,
                                               "mean": round(mean, 2)}
            rows.append((f"fig9a/{kind}/{name}", 0,
                         f"mean_size={round(mean, 2)};hist={hist}"))
    return dist, rows


def device_cgm_trace(n: int):
    return synth_trace(SynthConfig(
        kind="spotify", n_items=n, n_servers=20, n_requests=8000,
        t_max=20.0, bundle_cover=1.0, bundle_zipf=0.7, seed=0))


def time_device_cgm(n: int, device) -> dict:
    """Warm wall seconds of the windowed AKPC replay with the clique
    generation on the device and on the host (its hooks the same kernels
    on ``device``); the two must cost the same."""
    tr = device_cgm_trace(n)
    params = CostParams()
    t_cg = t_cg_for(tr, params)

    def timed(hooks: dict):
        def pol():
            return get_policy("akpc", params=params, t_cg=t_cg,
                              top_frac=0.5, **hooks)
        run_policy(pol(), tr, device=device)          # warm-up pass
        t0 = time.perf_counter()
        res = run_policy(pol(), tr, device=device)
        return time.perf_counter() - t0, res

    dev_s, dev = timed({})
    mm, pe = cgm_hooks(device)
    host_s, host = timed({"crm_matmul": mm, "pair_edges": pe})
    if dev.loop_stats.get("path") == "host_schedule" or \
            host.loop_stats.get("path") != "host_schedule":
        raise AssertionError(f"bench_cgm items={n}: the two runs took "
                             f"{dev.loop_stats.get('path')} and "
                             f"{host.loop_stats.get('path')}")
    same_costs(dev, host, f"bench_cgm items={n}")
    return {
        "device_seconds": round(dev_s, 4),
        "host_cgm_seconds": round(host_s, 4),
        "n_windows": dev.n_windows,
        "device_us_per_window": round(dev_s / max(1, dev.n_windows) * 1e6),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small item sweep + the scalar-oracle gate")
    ap.add_argument("--requests", type=int, default=N_SWEEP)
    device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows, payload = [], {"dist": {}, "runtime": {},
                         "runtime_scalar_oracle": {},
                         "speedup_vs_scalar_oracle": {},
                         "device": str(device)}
    # (b) first: the (a) replays' allocations skew millisecond timings
    regressions = []
    for n in (SMOKE_ITEMS if args.smoke else RUNTIME_ITEMS):
        dt, n_cliques = time_clique_gen(n, device)
        oracle = time_clique_gen_oracle(n)
        payload["runtime"][n] = round(dt, 4)
        payload["runtime_scalar_oracle"][n] = round(oracle, 4)
        payload["speedup_vs_scalar_oracle"][n] = round(oracle / dt, 1)
        rows.append((f"fig9b/items={n}", int(dt * 1e6),
                     f"seconds={round(dt, 4)};cliques={n_cliques};"
                     f"scalar_oracle={round(oracle, 4)}"))
        if args.smoke and dt >= oracle:
            regressions.append(f"items={n}: {dt:.4f}s >= scalar oracle "
                               f"{oracle:.4f}s on this machine")
    if not args.smoke:
        payload["dist"], rows_a = size_dist(args.requests, device)
        rows += rows_a
        cgm_items = {}
        for n in DEVICE_CGM_ITEMS:
            row = time_device_cgm(n, device)
            cgm_items[n] = row
            rows.append((
                f"bench_cgm/items={n}", int(row["device_seconds"] * 1e6),
                f"device={row['device_seconds']}s;"
                f"host_cgm={row['host_cgm_seconds']}s;"
                f"windows={row['n_windows']};"
                f"us_per_window={row['device_us_per_window']}"))
        save_json("BENCH_cgm_torch", {"trace": "spotify/8000req",
                                      "device": str(device),
                                      "items": cgm_items})
    save_json("fig9_cliques_runtime_torch", payload)
    emit(rows)
    if regressions:
        print("CGM RUNTIME REGRESSION:\n  " + "\n  ".join(regressions),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
