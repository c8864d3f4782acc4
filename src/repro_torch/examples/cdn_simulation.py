"""Paper-style CDN simulation: both traces, the main methods, an alpha
mini-sweep (a compact Figs. 5-7), plus three live-operations vignettes:
mid-stream checkpointing of an online AKPC session (snapshot -> restore ->
identical resume), a HETEROGENEOUS deployment (per-server prices, real
item sizes, ``cost_model="heterogeneous"``) where AKPC still beats
per-item fetching, and a LEARNED-policy day: train the keep/evict scorer
on yesterday's regime-shift trace, serve today's through the ``learned``
registry policy.

    PYTHONPATH=src python -m repro_torch.examples.cdn_simulation [--requests N]
        [--device cpu]

The port of ``examples/cdn_simulation.py``: every replay and the scorer's
training run on ``--device`` (default CUDA); ``--requests`` cuts every
trace to N requests (default: the reference's 40,000 for the sweep,
20,000 for the checkpoint and heterogeneous vignettes, 6,000 a day for
the learned one).  Each function returns the numbers it prints.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import (
    CacheEnvironment,
    CacheSession,
    CostParams,
    get_cost_model,
    get_policy,
    opt_lower_bound,
    run_policy,
)
from ..learned import train_policy
from ..traces import SynthConfig, paper_trace, synth_trace


def _t_cg(env, cost_model="table1"):
    return 0.3 * float(get_cost_model(cost_model, env).dt().max())


def sweep(device=None, n_requests: int = 40_000) -> dict:
    """(kind, alpha) -> each method's total over OPT's."""
    out = {}
    for kind in ("netflix", "spotify"):
        tr = paper_trace(kind, n_requests=n_requests)
        print(f"\n=== {kind} ===")
        for alpha in (0.6, 0.8, 1.0):
            params = CostParams(alpha=alpha)
            t_cg = _t_cg(CacheEnvironment.from_trace(tr, params))
            kw = dict(params=params, t_cg=t_cg, top_frac=1.0)
            akpc = run_policy(get_policy("akpc", **kw), tr,
                              device=device).total
            pc = run_policy(get_policy("packcache", **kw), tr,
                            device=device).total
            nop = run_policy(get_policy("no_packing", params=params), tr,
                             device=device).total
            opt = opt_lower_bound(tr, params).total
            out[(kind, alpha)] = {"akpc": akpc, "packcache": pc,
                                  "no_packing": nop, "opt": opt}
            print(f"alpha={alpha}: AKPC {akpc/opt:.2f}x  PackCache "
                  f"{pc/opt:.2f}x  NoPacking {nop/opt:.2f}x  (vs OPT=1)")
    return out


def live_checkpoint_vignette(device=None, n_requests: int = 20_000) -> dict:
    """A CDN operator checkpoints the live cache state mid-stream and fails
    over to a standby that resumes bit-identically."""
    params = CostParams()
    tr = paper_trace("netflix", n_requests=n_requests)
    t_cg = _t_cg(CacheEnvironment.from_trace(tr, params))

    def mk():
        return CacheSession(
            get_policy("akpc", params=params, t_cg=t_cg, top_frac=1.0),
            tr.n, tr.m, device=device)

    primary = mk()
    half = tr.n_requests // 2
    primary.feed(tr.items[:half], tr.servers[:half], tr.times[:half])
    snap = primary.snapshot()                  # a tree of numpy arrays
    at_snapshot = primary.costs.total
    print(f"\ncheckpointed at t={primary.now:.2f}: "
          f"{primary.costs.n_requests} requests, total {at_snapshot:.0f}")

    standby = mk().restore(snap)               # failover
    for sess in (primary, standby):
        sess.feed(tr.items[half:], tr.servers[half:], tr.times[half:])
    if primary.costs.as_dict() != standby.costs.as_dict() or \
            not np.array_equal(primary.engine.state.E, standby.engine.state.E):
        raise AssertionError("the standby did not resume bit-identically")
    print(f"standby resumed bit-identically: total "
          f"{standby.costs.total:.0f}")
    return {"at_snapshot": at_snapshot, "primary": primary.costs.total,
            "standby": standby.costs.total}


def heterogeneous_vignette(device=None, n_requests: int = 20_000) -> dict:
    """A real fleet: edge servers with different bandwidth / storage
    contracts (lognormal lam_j / mu_j, so dt_j varies per server) serving
    items with real volumes, priced by the "heterogeneous" cost model."""
    params = CostParams()
    tr = synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=100, n_requests=n_requests,
        t_max=72.0, bundle_cover=1.0, bundle_zipf=0.7, server_affinity=2,
        seed=0, size_dist="lognormal",
    ))
    skew = CacheEnvironment.skewed(tr.n, tr.m, params, price_sigma=1.0, seed=1)
    env = CacheEnvironment.from_trace(tr, params,
                                      lam_j=skew.lam_j, mu_j=skew.mu_j)
    t_cg = _t_cg(env, "heterogeneous")
    kw = dict(params=params, env=env, cost_model="heterogeneous")
    akpc = run_policy(get_policy("akpc", t_cg=t_cg, top_frac=1.0, **kw), tr,
                      device=device)
    nop = run_policy(get_policy("no_packing", **kw), tr, device=device)
    print(f"\nheterogeneous fleet ({tr.m} servers, lognormal prices+sizes):")
    print(f"  AKPC {akpc.total:,.0f}  vs  NoPacking {nop.total:,.0f}  "
          f"-> {100 * (1 - akpc.total / nop.total):.1f}% saved "
          f"(model={akpc.costs.model})")
    return {"akpc": akpc.total, "no_packing": nop.total,
            "model": akpc.costs.model}


def learned_vignette(device=None, n_requests: int = 6_000) -> dict:
    """Traffic shifts regime overnight (catalog launch): hindsight-train
    the learned keep/evict scorer on yesterday's trace, serve today's."""
    params = CostParams(rho=4.0)     # expensive prepaid rent: keep/evict bites

    def mk(seed):
        return synth_trace(SynthConfig(
            kind="netflix", n_items=60, n_servers=12, n_requests=n_requests,
            t_max=600.0, bundle_cover=1.0, bundle_zipf=0.7, server_affinity=2,
            load_profile="regime_shift", load_strength=0.25, load_peak=0.4,
            seed=seed,
        ))

    yesterday, today = mk(200), mk(101)
    # span-scaled window (as in fig11): 0.3*dt is too short to observe
    # co-access on this trace, and a scorer trained on tiny windows
    # degenerates to keep-nothing
    env = CacheEnvironment.from_trace(yesterday, params)
    span = float(yesterday.times[-1] - yesterday.times[0])
    t_cg = min(max(_t_cg(env), span / 50.0), span / 4.0)
    lp = train_policy(yesterday, t_cg=t_cg, params=params, device=device)
    totals = {
        name: run_policy(get_policy(name, params=params, **kw), today,
                         device=device).total
        for name, kw in (
            ("no_packing", {}),
            ("ttl", dict(t_cg=t_cg)),
            ("learned", dict(t_cg=t_cg, learned=lp)),
        )
    }
    print("\nregime-shift day, trained on yesterday's trace:")
    for name, tot in sorted(totals.items(), key=lambda kv: kv[1]):
        print(f"  {name:10s} {tot:10,.0f}")
    print(f"  -> learned saves "
          f"{100 * (1 - totals['learned'] / totals['no_packing']):.1f}% "
          f"vs no_packing")
    return totals


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=None,
                    help="cut every trace to this many requests")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without it) or cpu")
    args = ap.parse_args(argv)
    n = {} if args.requests is None else {"n_requests": args.requests}
    return {
        "sweep": sweep(args.device, **n),
        "checkpoint": live_checkpoint_vignette(args.device, **n),
        "heterogeneous": heterogeneous_vignette(args.device, **n),
        "learned": learned_vignette(args.device, **n),
    }


if __name__ == "__main__":
    main()
