"""The sweep benchmark: a lane-stacked sweep against the serial loop on
the fig6 grid, and the sweep grids and parity checks the other drivers
share (port of ``benchmarks/sweep_bench.py``, and of fig10's grid).

    python -m repro_torch.bench.sweep_bench [--device cpu]
    python -m repro_torch.bench.sweep_bench --smoke [--device cpu]
    python -m repro_torch.bench.sweep_bench --mesh [--smoke] [--device cpu]

:func:`main` replays an (alpha x rho) sensitivity grid of AKPC points over
the Table-II ``netflix`` trace two ways on the same device: the
``"serial"`` backend (one ``run_policy`` a point, each with its own
clique generation) and one :class:`~repro_torch.core.sweep.SweepEngine`
call (points of one clique-generation period share a host schedule, each
cohort of schedules is one laned scan), the sweep cold (first call of the
process) and warm (second call).  Every point's costs equal the serial
run's at 1e-9 before any time is kept.  The payload lands in
``BENCH_sweep_torch.json`` under ``REPRO_RESULTS``.  Env knobs as the
reference's: ``REPRO_SWEEP_BENCH_REQUESTS`` (default 150,000),
``REPRO_SWEEP_BENCH_ALPHAS`` (64) and ``REPRO_SWEEP_BENCH_RHOS`` (4); the
full run asserts a >= 5x cold speedup.

``--smoke``: 60,000 requests, 16 x 2 points, the warm sweep must beat the
serial loop, and the mixed-shape gate (:func:`mixed_shape_gate`): four
points of distinct (n, m) under a ``bucketed`` layout replay as one scan
a bucket cohort (2 cohorts), each equal to its serial run.

``--mesh`` adds the reference's devices x points rows
(:func:`bench_mesh`): the same grid swept on a
:func:`~repro_torch.launch.mesh.make_sweep_mesh` of 1, 2 and 4 devices
(scenario lanes split over them) and on 4 devices as 2 x 2 and 1 x 4
``("scenario", "state_row")`` meshes under the ``row_sharded`` layout,
each row after parity against the mesh-less sweep (costs at 1e-9, state
float for float).  The devices are distinct CUDA devices where the
machine has enough, else logical shards of the first one (of the CPU with
``--device cpu``): on one card the rows show what a logical mesh costs,
not how a sweep scales.

Shared pieces:

* :func:`build_grid`: the fig6 (alpha x rho) sensitivity grid of AKPC
  points; every alpha of one clique-generation period shares a host
  schedule, so a sweep replays them as the lanes of one scan;
* :func:`fig10_points`: fig10's (item-size distribution x server-price
  skew x method) grid under the heterogeneous cost model, per-server dt;
* :func:`same_costs` / :func:`assert_parity`: two runs' costs, or a
  sweep's points against a serial loop's, integer fields exact and float
  fields at rtol 1e-9.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core import CacheEnvironment, CostParams, SweepEngine, SweepPoint
from ..core.replay import resolve_device
from ..core.state_layout import StateLayout
from ..launch.mesh import canonical_device, make_sweep_mesh
from ..traces import SynthConfig, paper_trace, synth_trace
from .common import device_arg, emit, save_json, t_cg_for

INT_FIELDS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred")
FLOAT_FIELDS = ("transfer", "caching", "keepalive_rent", "total")

#: fig10: lognormal skew of lam_j / mu_j, item-size distributions, methods
PRICE_SIGMAS = (0.0, 0.5, 1.0)
SIZE_DISTS = ("unit", "lognormal")
FIG10_METHODS = ("no_packing", "packcache", "akpc")
#: fig10's setup: 150 servers at ~2.8 requests per server per unit time
N_SERVERS = 150
REQ_RATE_PER_SERVER = 2.8
#: the seed of fig10's server prices
PRICE_SEED = 1


def build_grid(trace, n_alphas: int, n_rhos: int) -> list[SweepPoint]:
    """fig6-style grid: alpha x rho sensitivity of the proposed method."""
    alphas = np.linspace(0.6, 1.0, n_alphas)
    rhos = np.linspace(1.0, 6.0, n_rhos)
    pts = []
    for rho in rhos:
        for alpha in alphas:
            params = CostParams(alpha=float(alpha), rho=float(rho))
            pts.append(SweepPoint(
                "akpc", trace,
                dict(params=params, t_cg=t_cg_for(trace, params),
                     top_frac=1.0),
                tag=f"alpha={alpha:.3f}/rho={rho:.2f}"))
    return pts


def same_costs(a, b, tag: str = "") -> None:
    """Two runs' costs: integer fields exact, float fields at rtol 1e-9."""
    da, db = a.costs.as_dict(), b.costs.as_dict()
    for f in INT_FIELDS:
        if da[f] != db[f]:
            raise AssertionError(f"{tag} {f}: {da[f]} != {db[f]}")
    for f in FLOAT_FIELDS:
        if not np.isclose(da[f], db[f], rtol=1e-9, atol=0.0):
            raise AssertionError(f"{tag} {f}: {da[f]} != {db[f]} at 1e-9")


def assert_parity(pts, serial, swept) -> None:
    """A sweep's points against a serial loop's, point by point."""
    for pt, a, b in zip(pts, serial, swept):
        same_costs(a, b, pt.tag)


def sized_trace(n_requests: int, size_dist: str):
    """fig10's netflix trace: 60 items over 150 servers at fig10's request
    rate, with a chosen item-size distribution (the request stream is the
    same for every size distribution)."""
    t_max = n_requests / (N_SERVERS * REQ_RATE_PER_SERVER)
    return synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=N_SERVERS,
        n_requests=n_requests, t_max=t_max, bundle_cover=1.0,
        bundle_zipf=0.7, server_affinity=2, mean_session_len=6.0, seed=0,
        size_dist=size_dist,
    ))


def env_for(trace, params: CostParams, price_sigma: float) -> CacheEnvironment:
    """fig10's environment: lognormal per-server prices, the trace's sizes."""
    sk = CacheEnvironment.skewed(
        trace.n, trace.m, params, price_sigma=price_sigma, seed=PRICE_SEED)
    return CacheEnvironment.from_trace(
        trace, params, lam_j=sk.lam_j, mu_j=sk.mu_j)


def fig10_points(n_requests: int) -> list[SweepPoint]:
    """fig10's ``run_grid`` as sweep points: size distribution x price
    sigma x method under the heterogeneous cost model, t_cg from each
    scenario's max-over-servers dt."""
    params = CostParams()
    pts = []
    for size_dist in SIZE_DISTS:
        tr = sized_trace(n_requests, size_dist)
        for sigma in PRICE_SIGMAS:
            env = CacheEnvironment.resolve(env_for(tr, params, sigma), tr,
                                           params)
            t_cg = t_cg_for(tr, params, env=env, cost_model="heterogeneous")
            for name in FIG10_METHODS:
                # fig5's method set (benchmarks/common.py::method_policies)
                kw = {} if name == "no_packing" else dict(t_cg=t_cg,
                                                          top_frac=1.0)
                pts.append(SweepPoint(
                    name, tr, dict(params=params, env=env,
                                   cost_model="heterogeneous", **kw),
                    tag=f"{size_dist}/sigma={sigma}/{name}"))
    return pts


def state_bytes_telemetry(n: int, m: int) -> dict:
    """Device state bytes of one scenario per layout at (n, m)."""
    return {"n_items": n, "n_servers": m,
            "dense": StateLayout().state_bytes(n, m),
            "bucketed": StateLayout(kind="bucketed").state_bytes(n, m)}


#: the mixed-shape gate's layout and (n, m) points: two bucket cohorts
MIXED_LAYOUT = StateLayout(kind="bucketed", row_bucket=64, col_bucket=32)
MIXED_SHAPES = ((50, 20), (60, 25), (100, 40), (120, 48))


def mixed_shape_points() -> list[SweepPoint]:
    pts = []
    for seed, (n, m) in enumerate(MIXED_SHAPES):
        tr = synth_trace(SynthConfig(
            kind="netflix", n_items=n, n_servers=m, n_requests=3000,
            t_max=3.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed))
        params = CostParams()
        pts.append(SweepPoint(
            "akpc", tr,
            dict(params=params, t_cg=t_cg_for(tr, params), top_frac=1.0),
            tag=f"n={n}/m={m}"))
    return pts


def mixed_shape_gate(device=None) -> dict:
    """The bucketed mixed-shape contract: one scan a bucket cohort
    (strictly fewer than the points), every point equal to its serial
    run."""
    lay = MIXED_LAYOUT
    pts = mixed_shape_points()
    cohorts = len({lay.state_dims(n, m) for n, m in MIXED_SHAPES})
    eng = SweepEngine(layout=lay, device=device)
    swept = eng.run(pts)
    scans = len(eng.last_stats["groups"])
    ref = SweepEngine(backend="serial", device=device).run(pts)
    assert_parity(pts, ref, swept)
    if not cohorts < len(pts):
        raise AssertionError("gate grid must be mixed-shape")
    if scans > cohorts:
        raise AssertionError(
            f"bucketed mixed-shape sweep made {scans} scans for {cohorts} "
            f"cohorts ({len(pts)} points)")
    print(f"# mixed-shape gate: {len(pts)} points -> {cohorts} cohorts, "
          f"{scans} scans, parity OK")
    return {"points": len(pts), "cohorts": cohorts, "scans": scans,
            "lanes": [g["lanes"] for g in eng.last_stats["groups"]],
            "layout": {"tag": lay.tag, "row_bucket": lay.row_bucket,
                       "col_bucket": lay.col_bucket}}


#: the --mesh rows: (devices, state_rows) of each mesh
MESH_SHAPES = ((1, 1), (2, 1), (4, 1), (4, 2), (4, 4))


def mesh_devices(n_devices: int, device=None) -> list:
    """``n_devices`` distinct CUDA devices when the machine has them, else
    logical shards (repeats) of ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [canonical_device(dev)] * n_devices


def bench_mesh(n: int, n_alphas: int, n_rhos: int, device=None) -> list:
    """Devices x points rows: the fig6 grid over ``n`` requests swept on
    each mesh of :data:`MESH_SHAPES` (rows split under ``row_sharded``
    when ``state_rows`` > 1), cold then warm, each run held against the
    mesh-less sweep first."""
    trace = paper_trace("netflix", n_requests=n, seed=0)
    pts = build_grid(trace, n_alphas, n_rhos)
    base = SweepEngine(device=device).run(pts)
    rows = []
    for n_dev, state_rows in MESH_SHAPES:
        mesh = make_sweep_mesh(n_dev, state_rows,
                               devices=mesh_devices(n_dev, device))
        lay = (StateLayout(kind="row_sharded", mesh=mesh) if state_rows > 1
               else None)
        eng = SweepEngine(mesh=mesh, layout=lay)
        t0 = time.perf_counter()
        cold = eng.run(pts)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = eng.run(pts)
        t_warm = time.perf_counter() - t0
        for got in (cold, warm):
            assert_parity(pts, base, got)
            for pt, a, b in zip(pts, base, got):
                if not (np.array_equal(a.state.E, b.state.E)
                        and np.array_equal(a.state.anchor, b.state.anchor)):
                    raise AssertionError(f"{pt.tag}: mesh state differs")
        groups = eng.last_stats["groups"]
        row = {"physical_devices": mesh.physical_devices,
               "logical_devices": mesh.size, "state_rows": state_rows,
               "mesh_shape": mesh.shape, "points": len(pts),
               "scans": len(groups),
               "lanes": [g["lanes"] for g in groups],
               "cold_seconds": t_cold, "warm_seconds": t_warm,
               "state_bytes_per_device": (lay or StateLayout())
               .state_bytes_per_device(trace.n, trace.m),
               "block_ops": sum(g.get("block_ops", 0) for g in groups),
               "device_copies": sum(g.get("device_copies", 0)
                                    for g in groups)}
        rows.append(row)
        print("# mesh: " + json.dumps(row), flush=True)
    if any(r["physical_devices"] < r["logical_devices"] for r in rows):
        print("# mesh: logical shards of one device: these rows are the "
              "cost of a logical mesh, not scaling", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small run: parity + the sweep must beat serial")
    ap.add_argument("--mesh", action="store_true",
                    help="also record devices x points mesh rows")
    device_arg(ap)
    args = ap.parse_args(argv)
    env = os.environ.get
    if args.smoke:
        n = int(env("REPRO_SWEEP_BENCH_REQUESTS", "60000"))
        n_alphas = int(env("REPRO_SWEEP_BENCH_ALPHAS", "16"))
        n_rhos = int(env("REPRO_SWEEP_BENCH_RHOS", "2"))
    else:
        n = int(env("REPRO_SWEEP_BENCH_REQUESTS", "150000"))
        n_alphas = int(env("REPRO_SWEEP_BENCH_ALPHAS", "64"))
        n_rhos = int(env("REPRO_SWEEP_BENCH_RHOS", "4"))

    trace = paper_trace("netflix", n_requests=n, seed=0)
    pts = build_grid(trace, n_alphas, n_rhos)

    serial_eng = SweepEngine(backend="serial", device=args.device)
    t0 = time.perf_counter()
    serial = serial_eng.run(pts)
    t_serial = time.perf_counter() - t0

    sweep_eng = SweepEngine(device=args.device)
    t0 = time.perf_counter()
    swept = sweep_eng.run(pts)
    t_sweep = time.perf_counter() - t0
    t0 = time.perf_counter()
    swept_warm = sweep_eng.run(pts)
    t_warm = time.perf_counter() - t0

    assert_parity(pts, serial, swept)
    assert_parity(pts, serial, swept_warm)
    print(f"# parity check on {len(pts)} points (cold + warm): OK")

    speedup = t_serial / t_sweep
    speedup_warm = t_serial / t_warm
    emit([
        (f"sweep/serial_{len(pts)}pts", int(t_serial / len(pts) * 1e6),
         f"{t_serial:.2f}s total"),
        (f"sweep/lanes_{len(pts)}pts", int(t_sweep / len(pts) * 1e6),
         f"{t_sweep:.2f}s total;{sweep_eng.last_n_schedules} schedules"),
        (f"sweep/lanes_warm_{len(pts)}pts", int(t_warm / len(pts) * 1e6),
         f"{t_warm:.2f}s total"),
        ("sweep/speedup", round(speedup, 2), "x cold"),
        ("sweep/speedup_warm", round(speedup_warm, 2), "x warm"),
    ])
    payload = {
        "n_requests": n,
        "grid": {"alphas": n_alphas, "rhos": n_rhos, "points": len(pts)},
        "policy": "akpc",
        "cost_model": "table1",
        "device": str(sweep_eng.device),
        "serial_seconds": t_serial,
        "sweep_seconds": t_sweep,
        "sweep_warm_seconds": t_warm,
        "speedup": speedup,
        "speedup_warm": speedup_warm,
        "n_schedules": sweep_eng.last_n_schedules,
        "scans": len(sweep_eng.last_stats["groups"]),
        "smoke": bool(args.smoke),
        "points_per_second_serial": len(pts) / t_serial,
        "points_per_second_sweep": len(pts) / t_sweep,
        "points_per_second_sweep_warm": len(pts) / t_warm,
        "state_layout": sweep_eng.layout.tag,
        "state_bytes": state_bytes_telemetry(trace.n, trace.m),
    }
    if args.smoke:
        payload["mixed_shape"] = mixed_shape_gate(args.device)
    if args.mesh:
        payload["mesh_scaling"] = bench_mesh(n, n_alphas, n_rhos,
                                             args.device)
    save_json("BENCH_sweep_torch", payload)
    if args.smoke:
        if t_warm >= t_serial:
            print(f"FAIL: warm sweep ({t_warm:.2f}s) no faster than the "
                  f"serial loop ({t_serial:.2f}s)")
            return 1
    elif speedup < 5.0:
        print(f"FAIL: the sweep only {speedup:.1f}x faster than serial")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
