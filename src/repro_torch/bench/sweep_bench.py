"""The sweep benchmarks' grids and parity check (port of
``benchmarks/sweep_bench.py::build_grid`` / ``assert_parity`` and of
fig10's grid).

* :func:`build_grid`: the fig6 (alpha x rho) sensitivity grid of AKPC
  points; every alpha of one clique-generation period shares a host
  schedule, so a sweep replays them as the lanes of one scan;
* :func:`fig10_points`: fig10's (item-size distribution x server-price
  skew x method) grid under the heterogeneous cost model, per-server dt;
* :func:`same_costs` / :func:`assert_parity`: two runs' costs, or a
  sweep's points against a serial loop's, integer fields exact and float
  fields at rtol 1e-9.

``chip_smoke.py`` runs both grids on the card as one ``SweepEngine`` call
each, against serial runs.
"""
from __future__ import annotations

import numpy as np

from ..core import CacheEnvironment, CostParams, SweepPoint
from ..traces import SynthConfig, synth_trace
from .common import t_cg_for

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
