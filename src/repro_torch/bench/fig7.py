"""Fig. 7 on the port: sensitivity to theta, gamma and omega.

    python -m repro_torch.bench.fig7 [--requests 40000] [--device cpu]
    python -m repro_torch.bench.fig7 --smoke [--device cpu]

The port of ``benchmarks/fig7_hyperparams.py``: the CRM threshold theta
(a), the clique-approximation threshold gamma (b) and the largest clique
omega (c), each axis alone at the default of the others, for ``akpc`` and
``akpc_base`` over the Table-II ``netflix`` and ``spotify`` traces, all in
one :class:`~repro_torch.core.sweep.SweepEngine` run on ``--device``
(default CUDA).  The points of one (trace, method) differ only in the
clique-generation knobs, so each such set is one device-CGM super-group:
one partition-free schedule and one laned device clique generation, 4
super-groups of 17 lanes for the whole grid.  Each point is reported
relative to the OPT lower bound of the port's
:func:`~repro_torch.core.baselines.opt_lower_bound`, as the reference's
payload is; it lands in ``fig7_hyperparams_torch.json`` under
``REPRO_RESULTS``.

``--smoke`` is the reference's device-CGM oracle gate: a 2 x 2 x 2 theta x
gamma x omega grid at top_frac 0.5 over 4,000 ``netflix`` requests runs
as one super-group; every lane's slot map at every T_CG boundary must
equal a walk of the port's host clique generation
(:func:`~repro_torch.core.cliques.generate_cliques` over
:func:`~repro_torch.core.crm.build_window_crm`), the sweep must make no
host clique-generation call (``cliques.CGM_CALLS`` stays flat) and build
one schedule.  The reference's second gate, the compact hot-space
workspace timed against the dense ``(n, n)`` workspace it replaced, is
not ported: the port has no dense workspace.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import CostParams, SweepEngine, SweepPoint, opt_lower_bound
from ..core import cliques as cliques_mod
from ..core.crm import build_window_crm
from ..traces import paper_trace
from .common import emit, save_json, t_cg_for

THETAS = (0.05, 0.1, 0.15, 0.2, 0.3, 0.5)
GAMMAS = (0.6, 0.7, 0.8, 0.85, 0.9, 1.0)
OMEGAS = (2, 3, 5, 7, 10)
METHODS = ("akpc", "akpc_base")
KINDS = ("netflix", "spotify")
#: the reference's figure budget (``REPRO_BENCH_SWEEP_REQUESTS``)
N_SWEEP = 40_000
TOP_FRAC = 1.0
AXES = (("theta", THETAS), ("gamma", GAMMAS), ("omega", OMEGAS))

SMOKE_THETAS = (0.1, 0.3)
SMOKE_GAMMAS = (0.6, 0.9)
SMOKE_OMEGAS = (3, 5)
SMOKE_TOP_FRAC = 0.5
SMOKE_REQUESTS = 4000


def grid_points(traces: dict) -> tuple[list, list]:
    """The fig7 grid over ``traces`` (kind -> trace): one SweepPoint a
    (kind, axis, value, method), and its ``(axis, kind, value)`` key."""
    pts, keys = [], []
    for kind, tr in traces.items():
        for axis, values in AXES:
            for v in values:
                params = CostParams(**{axis: v})
                t_cg = t_cg_for(tr, params)
                for method in METHODS:
                    pts.append(SweepPoint(method, tr, dict(
                        params=params, t_cg=t_cg, top_frac=TOP_FRAC,
                        cost_model="table1")))
                    keys.append((axis, kind, v))
    return pts, keys


def run_grid(n_requests: int, device=None) -> tuple[dict, SweepEngine]:
    """The whole grid in one sweep, priced relative to OPT."""
    traces = {k: paper_trace(k, n_requests=n_requests) for k in KINDS}
    pts, keys = grid_points(traces)
    eng = SweepEngine(device=device)
    res = eng.run(pts)
    opt = {}
    payload: dict = {axis: {} for axis, _ in AXES}
    for pt, key, r in zip(pts, keys, res):
        axis, kind, v = key
        if key not in opt:
            opt[key] = opt_lower_bound(traces[kind], CostParams(**{axis: v}))
        cell = payload[axis].setdefault(kind, {}).setdefault(v, {"opt": 1.0})
        cell[pt.policy] = round(r.costs.total / opt[key].total, 4)
    return payload, eng


def host_walk(tr, t_cg: float, theta: float, gamma: float, omega: int,
              top_frac: float) -> list:
    """The host clique generation's slot map at every T_CG boundary, on
    the replay engines' boundary walk."""
    times, R = tr.times, tr.n_requests
    next_cg = float(times[0]) + t_cg
    win_start = pos = 0
    prev = prev_crm = None
    parts = []
    while pos < R:
        cut = int(np.searchsorted(times, next_cg, side="left"))
        if cut <= pos:
            t = float(times[pos])
            crm = build_window_crm(tr.items[win_start:pos], tr.n, theta,
                                   top_frac=top_frac)
            prev = cliques_mod.generate_cliques(prev, prev_crm, crm, tr.n,
                                                omega, gamma)
            parts.append(prev.clique_of.copy())
            prev_crm = crm
            win_start = pos
            while next_cg <= t:
                next_cg += t_cg
            continue
        pos = cut
    return parts


def smoke(device=None) -> int:
    """The device-CGM oracle gate (module docstring)."""
    tr = paper_trace("netflix", n_requests=SMOKE_REQUESTS)
    t_cg = t_cg_for(tr, CostParams())
    combos = [(th, g, om) for th in SMOKE_THETAS for g in SMOKE_GAMMAS
              for om in SMOKE_OMEGAS]
    pts = [SweepPoint("akpc", tr, dict(
        params=CostParams(theta=th, gamma=g, omega=om), t_cg=t_cg,
        top_frac=SMOKE_TOP_FRAC)) for th, g, om in combos]
    eng = SweepEngine(device=device)
    before = cliques_mod.CGM_CALLS
    eng.run(pts)
    failures = []
    if cliques_mod.CGM_CALLS != before:
        failures.append("the sweep made host clique-generation calls")
    if eng.last_n_schedules != 1:
        failures.append(f"the sweep built {eng.last_n_schedules} schedules, "
                        "not 1")
    groups = eng.last_stats["cgm_groups"]
    if len(groups) != 1 or groups[0]["lanes"] != len(combos):
        failures.append(f"super-groups {[g['lanes'] for g in groups]}, not "
                        f"one of {len(combos)} lanes")
    ofs = eng.last_cgm_ofs
    nbd = len(ofs[0]) if ofs[0] is not None else 0
    if nbd < 3:
        failures.append(f"need chained windows, got {nbd}")
    for lane, (th, g, om) in enumerate(combos):
        want = host_walk(tr, t_cg, th, g, om, SMOKE_TOP_FRAC)
        if len(want) != nbd:
            failures.append(f"theta={th} gamma={g} omega={om}: {len(want)} "
                            f"host windows against {nbd}")
            continue
        bad = [w for w in range(nbd)
               if not np.array_equal(ofs[lane][w], want[w])]
        if bad:
            failures.append(f"theta={th} gamma={g} omega={om}: slot maps "
                            f"differ at windows {bad}")
    syncs = sum(v for g in groups for k, v in g.items()
                if k.startswith("sync_"))
    emit([("fig7/smoke_oracle_gate", 0,
           f"grid={len(combos)}pts;windows={nbd};syncs={syncs};"
           f"status={'FAIL' if failures else 'OK'}")])
    if failures:
        print("FAIL:\n  " + "\n  ".join(failures))
        return 1
    print(f"OK: {len(combos)} lanes x {nbd} windows equal the host clique "
          "generation, no host CGM call, one schedule")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=N_SWEEP)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    payload, eng = run_grid(args.requests, device=args.device)
    tags = {"theta": "fig7a", "gamma": "fig7b", "omega": "fig7c"}
    rows = []
    for axis, kinds in payload.items():
        for kind, cells in kinds.items():
            for v, rel in cells.items():
                rows.append((f"{tags[axis]}/{kind}/{axis}={v}", 0,
                             f"akpc={rel['akpc']};base={rel['akpc_base']}"))
    save_json("fig7_hyperparams_torch", payload)
    emit(rows)
    print(f"# {eng.last_n_schedules} schedules, "
          f"{[g['lanes'] for g in eng.last_stats['cgm_groups']]} lanes, "
          f"{eng.last_wall:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
