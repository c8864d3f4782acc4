"""Fig. 8 on the port: scalability in (a) servers, (b) data items and (c)
batch size (requests per T_CG window).

    python -m repro_torch.bench.fig8 [--requests N] [--device cpu]
    python -m repro_torch.bench.fig8 --smoke [--device cpu]

The port of ``benchmarks/fig8_scalability.py``.  This is the figure whose
points differ in (n, m), so the whole mixed grid, all three axes, is ONE
:func:`~repro_torch.bench.common.run_method_grid` call on ``--device``
(default CUDA) under the reference's ``bucketed`` state layout (rows in
buckets of 1,024, columns in buckets of 256): points whose (n, m) round up
to the same padded dims are one bucket cohort and replay as the lanes of
ONE scan, so the sweep makes one scan a cohort, not one a point (the
port's counterpart of the reference's "compiles <= cohorts").  Each
point's ``akpc`` and ``no_packing`` totals are reported relative to OPT;
the payload, with its ``state_layout`` block, lands in
``fig8_scalability_torch.json`` under ``REPRO_RESULTS``.

``--smoke`` runs the reduced mixed grid (servers 60 / 300, items 60 / 240,
batches 50 / 200 at 4,000 requests) and asserts the reference's gates:
the grid is mixed (1 < cohorts < points), the sweep made at most one scan
a cohort, and every point's totals equal the ``"serial"`` backend's (one
``run_policy`` a point, dense, on the same device) at 1e-9.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.state_layout import StateLayout
from ..traces import SynthConfig, synth_trace
from .common import N_SWEEP, device_arg, emit, run_method_grid, save_json

SERVERS = [60, 150, 300, 600, 1200]
ITEMS = [60, 240, 960, 3600]
BATCHES = [50, 100, 200, 500]
METHODS = ("akpc", "no_packing", "opt")
#: fig8's bucket steps: the servers axis collapses to a few column
#: cohorts and every item count <= 4096 shares one row bucket
LAYOUT = StateLayout(kind="bucketed", row_bucket=1024, col_bucket=256)

SMOKE_SERVERS = [60, 300]
SMOKE_ITEMS = [60, 240]
SMOKE_BATCHES = [50, 200]
SMOKE_REQUESTS = 4000


def _trace(n_items=60, n_servers=600, seed=0, n_requests=N_SWEEP):
    return synth_trace(SynthConfig(
        kind="netflix", n_items=n_items, n_servers=n_servers,
        n_requests=n_requests, t_max=6.0 * n_requests / 100_000.0,
        bundle_cover=1.0, bundle_zipf=0.7, server_affinity=2, seed=seed))


def build_grid(smoke: bool = False, n_requests: int | None = None):
    """The mixed-(n, m) fig8 grid as ONE run_method_grid input, and its
    labels: ``labels[i] = ("servers" | "items" | "batch", value)``."""
    nreq = n_requests or (SMOKE_REQUESTS if smoke else N_SWEEP)
    grid, labels = [], []
    for m in (SMOKE_SERVERS if smoke else SERVERS):
        grid.append({"trace": _trace(n_servers=m, n_requests=nreq),
                     "methods": METHODS})
        labels.append(("servers", m))
    for n in (SMOKE_ITEMS if smoke else ITEMS):
        grid.append({"trace": _trace(n_items=n, n_requests=nreq),
                     "methods": METHODS})
        labels.append(("items", n))
    tr = _trace(n_requests=nreq)
    span = float(tr.times[-1] - tr.times[0])
    for b in (SMOKE_BATCHES if smoke else BATCHES):
        # batch size -> a clique-generation window of b requests on average
        grid.append({"trace": tr, "methods": METHODS,
                     "t_cg": span * b / tr.n_requests})
        labels.append(("batch", b))
    return grid, labels


def n_cohorts(grid) -> int:
    """Bucket cohorts of the grid: distinct padded state dims."""
    return len({LAYOUT.state_dims(g["trace"].n, g["trace"].m) for g in grid})


def run(grid, device=None, backend: str = "torch") -> tuple[list, dict]:
    """The grid in one sweep; the torch backend under :data:`LAYOUT`, the
    serial one dense.  Returns the results and the sweep's stats."""
    stats: dict = {}
    res = run_method_grid(grid, backend=backend, device=device, stats=stats,
                          layout=LAYOUT if backend == "torch" else None)
    return res, stats


def payload_of(grid, labels, res, scans: int) -> dict:
    payload = {"servers": {}, "items": {}, "batch": {}}
    for (axis, val), r in zip(labels, res):
        ref = r.get("opt") or r["no_packing"]
        rel = {k: round(v["total"] / ref["total"], 4) for k, v in r.items()}
        payload[axis][val] = {"rel": rel, "akpc_abs": r["akpc"]["total"]}
    tr0 = grid[0]["trace"]
    payload["state_layout"] = {
        "tag": LAYOUT.tag, "row_bucket": LAYOUT.row_bucket,
        "col_bucket": LAYOUT.col_bucket,
        "points": len(grid), "cohorts": n_cohorts(grid), "scans": scans,
        # the padding overhead of each point against its dense footprint
        "state_bytes": {
            f"{axis}={val}": LAYOUT.state_bytes(g["trace"].n, g["trace"].m)
            for (axis, val), g in zip(labels, grid)},
        "dense_bytes_first_point": StateLayout().state_bytes(tr0.n, tr0.m),
    }
    return payload


def smoke_gate(grid, labels, res, scans: int, device=None) -> list:
    """The reference's smoke gates; returns the failures."""
    k = n_cohorts(grid)
    fails = []
    if not 1 < k < len(grid):
        fails.append(f"smoke grid must be mixed-shape: {k} cohorts of "
                     f"{len(grid)}")
    if scans > k:
        fails.append(f"bucketed sweep made {scans} scans for {k} cohorts")
    ref, _ = run(grid, device=device, backend="serial")
    for (axis, val), r, rr in zip(labels, res, ref):
        for meth in ("akpc", "no_packing"):
            a, b = r[meth]["total"], rr[meth]["total"]
            if not np.isclose(a, b, rtol=1e-9, atol=1e-9):
                fails.append(f"{axis}={val} {meth}: swept {a} != serial {b}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced mixed grid + the parity / scan gates")
    ap.add_argument("--requests", type=int, default=None)
    device_arg(ap)
    args = ap.parse_args(argv)
    grid, labels = build_grid(args.smoke, args.requests)
    res, stats = run(grid, device=args.device)
    scans = len(stats["groups"])
    payload = payload_of(grid, labels, res, scans)
    rows, base = [], {}
    for (axis, val), r in zip(labels, res):
        rel = payload[axis][val]["rel"]
        base.setdefault(axis, r["akpc"]["total"])
        rows.append((f"fig8{'abc'['servers items batch'.split().index(axis)]}"
                     f"/{axis}={val}", 0,
                     f"akpc_rel={rel['akpc']};"
                     f"abs_vs_base={round(r['akpc']['total'] / base[axis], 2)}"))
    rows.append(("fig8/scans", scans,
                 f"cohorts={n_cohorts(grid)};points={len(grid)};"
                 f"lanes={[g['lanes'] for g in stats['groups']]}"))
    if args.smoke:
        fails = smoke_gate(grid, labels, res, scans, args.device)
        if fails:
            print("FAIL:\n  " + "\n  ".join(fails))
            return 1
        print(f"fig8 --smoke: {len(grid)} points, {n_cohorts(grid)} "
              f"cohorts, {scans} scans, serial parity 1e-9 OK", flush=True)
    save_json("fig8_scalability_torch", payload)
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
