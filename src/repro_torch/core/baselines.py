"""Baselines of the paper's evaluation (§V.B): batch entry points and OPT.

The port's counterpart of ``repro.core.baselines``.  The methods are the
registered policies of :mod:`repro_torch.core.policy` (``no_packing``,
``packcache``, ``dp_greedy``); the ``run_*`` functions replay a trace
under one of them through :func:`~repro_torch.core.policy.run_policy` on
``device`` (default CUDA) and return its costs.

``opt_lower_bound`` is a host numpy copy of the reference's rigorous
lower bound on the offline optimum: per (item, server) access sequence,
each first access costs at least the cheapest per-item packed transfer
share ``c_min = (alpha + (1 - alpha) / omega) * lam`` and each re-access
after a gap g at least ``min(mu * g, c_min)``.  Under a heterogeneous
environment the same argument holds at each server's prices and each
item's volume.  It is valid for the ``table1`` and ``heterogeneous``
models only: ``tiered`` schedules can undercut the share, and are refused.
"""
from __future__ import annotations

import numpy as np

from ..traces.loader import Trace
from .cost import CacheEnvironment, CostBreakdown, CostParams
from .engine import CachingCharge
from .policy import get_policy, greedy_pair_matching, run_policy

__all__ = [
    "OPT_BOUND_MODELS",
    "greedy_pair_matching",
    "opt_lower_bound",
    "run_dp_greedy",
    "run_no_packing",
    "run_packcache2",
]

#: cost models whose pricing admits the opt_lower_bound argument
OPT_BOUND_MODELS = ("table1", "heterogeneous")


def run_no_packing(
    trace: Trace,
    params: CostParams,
    caching_charge: CachingCharge = "requested",
    batch_size: int | None = None,
    env: CacheEnvironment | None = None,
    cost_model: str = "table1",
    *,
    device=None,
) -> CostBreakdown:
    pol = get_policy("no_packing", params=params, caching_charge=caching_charge,
                     env=env, cost_model=cost_model)
    return run_policy(pol, trace, device=device, batch_size=batch_size).costs


def run_packcache2(
    trace: Trace,
    params: CostParams,
    t_cg: float = 50.0,
    top_frac: float = 0.1,
    caching_charge: CachingCharge = "requested",
    batch_size: int | None = None,
    env: CacheEnvironment | None = None,
    cost_model: str = "table1",
    *,
    device=None,
) -> CostBreakdown:
    """Online 2-packing (PackCache, Wu et al. [2])."""
    pol = get_policy("packcache", params=params, t_cg=t_cg, top_frac=top_frac,
                     caching_charge=caching_charge, env=env,
                     cost_model=cost_model)
    return run_policy(pol, trace, device=device, batch_size=batch_size).costs


def run_dp_greedy(
    trace: Trace,
    params: CostParams,
    top_frac: float = 0.1,
    caching_charge: CachingCharge = "requested",
    batch_size: int | None = None,
    env: CacheEnvironment | None = None,
    cost_model: str = "table1",
    *,
    device=None,
) -> CostBreakdown:
    """Offline 2-packing (DP_Greedy, Huang et al. [4])."""
    pol = get_policy("dp_greedy", params=params, top_frac=top_frac,
                     caching_charge=caching_charge, env=env,
                     cost_model=cost_model)
    return run_policy(pol, trace, device=device, batch_size=batch_size).costs


def opt_lower_bound(
    trace: Trace,
    params: CostParams | None = None,
    env: CacheEnvironment | None = None,
    cost_model: str = "table1",
) -> CostBreakdown:
    """Rigorous lower bound on the offline optimal cost (module docstring),
    on the host in numpy f64, equal to the reference's bit for bit."""
    if cost_model not in OPT_BOUND_MODELS:
        raise ValueError(
            f"opt_lower_bound is only valid for {OPT_BOUND_MODELS}; "
            f"{cost_model!r} pricing can undercut the per-item packed share")
    if params is None:
        params = env.params if env is not None else CostParams()
    elif env is not None and params != env.params:
        raise ValueError(
            "params and env.params disagree; build the environment with "
            "the same CostParams you pass to opt_lower_bound")
    # flatten to (item, server, time) triplets
    mask = trace.items >= 0
    reps = mask.sum(axis=1)
    it = trace.items[mask]
    sv = np.repeat(trace.servers, reps)
    tm = np.repeat(trace.times, reps)
    key = it.astype(np.int64) * trace.m + sv
    order = np.lexsort((tm, key))
    key_s, tm_s = key[order], tm[order]
    new_seq = np.ones(key_s.shape[0], dtype=bool)
    new_seq[1:] = key_s[1:] != key_s[:-1]
    gaps = np.empty_like(tm_s)
    gaps[new_seq] = np.inf                 # first access of each (d, j)
    cont = ~new_seq
    gaps[cont] = tm_s[cont] - tm_s[np.nonzero(cont)[0] - 1]

    costs = CostBreakdown(model=cost_model)
    first = new_seq
    share = params.alpha + (1.0 - params.alpha) / params.omega
    # table1 ignores the environment's prices and sizes, so its bound must
    if cost_model != "heterogeneous" or env is None or env.homogeneous:
        c_min = share * params.lam
        costs.transfer += float(first.sum()) * c_min
        keep = params.mu * gaps[cont]
        refetch = np.minimum(keep, c_min)
        costs.transfer += float(refetch[keep >= c_min].sum())
        costs.caching += float(refetch[keep < c_min].sum())
        costs.n_misses = int(first.sum() + (keep >= c_min).sum())
    else:
        lam = env.lam_per_server()
        mu = env.mu_per_server()
        s = env.sizes()
        it_s, sv_s = it[order], sv[order]
        c_min = share * lam[sv_s] * s[it_s]
        costs.transfer += float(c_min[first].sum())
        keep = mu[sv_s[cont]] * s[it_s[cont]] * gaps[cont]
        cm = c_min[cont]
        refetch = np.minimum(keep, cm)
        costs.transfer += float(refetch[keep >= cm].sum())
        costs.caching += float(refetch[keep < cm].sum())
        costs.n_misses = int(first.sum() + (keep >= cm).sum())
    costs.n_requests = trace.n_requests
    costs.n_item_requests = int(mask.sum())
    return costs
