"""Fig. 11 on the port: non-stationary load, every registered policy ranked.

    python -m repro_torch.bench.fig11 [--requests 6000] [--device cpu]
    python -m repro_torch.bench.fig11 --smoke [--device cpu]

The port of ``benchmarks/fig11_stress_rank.py``: four load profiles x two
pricing models, every canonical registry policy (the ``learned``
keep-or-not policy trained on a held-out trace of the same scenario),
three eval-seed trace shards a point, replayed through the port's
:class:`~repro_torch.core.sweep.SweepEngine` on ``--device`` (default
CUDA).  Per (scenario, model) the payload records the merged totals, the
per-shard ``shard_stats`` and the ranking; it lands in
``BENCH_learned_torch.json`` under ``REPRO_RESULTS``.

``--smoke`` is the reference's gate (small traces, regime_shift/table1):
train on ``--device``, rank ``no_packing`` / ``ttl`` / ``packcache`` /
``dp_greedy`` / ``learned`` through the sweep, and fail unless
``learned`` strictly beats ``no_packing`` and at least one of the other
three; the reference's numpy-vs-jax replay parity becomes the sweep's
``learned`` total against a serial replay on the CPU, at 1e-9.
"""
from __future__ import annotations

import argparse
import sys

from ..core import (
    CacheEnvironment,
    CostParams,
    SweepEngine,
    SweepPoint,
    get_policy,
    list_policies,
    run_policy,
)
from ..learned import train_policy
from ..traces import SynthConfig, synth_trace
from .common import emit, save_json, t_cg_for

#: load profile -> load_strength (diurnal amplitude / crowd height x base /
#: regime rate ratio, as in ``traces.synthetic.load_rate``)
SCENARIOS = {
    "stationary": 0.0,
    "diurnal": 0.8,
    "flash_crowd": 4.0,
    "regime_shift": 0.25,
}
MODELS = ("table1", "heterogeneous")
#: canonical registry names (aliases like packcache2 resolve to these)
POLICIES = ("no_packing", "ttl", "dp_greedy", "packcache",
            "akpc_base", "akpc_no_acm", "akpc", "learned")
N_ITEMS, N_SERVERS = 60, 12
TRAIN_SEED = 200
EVAL_SEEDS = (101, 102, 103)
#: t_max = 0.1 * n_requests: ~8.3 requests per server per unit time over
#: 60 items, so hot-item revisit gaps straddle the rho=4 TTL
TIME_PER_REQUEST = 0.1
#: the smoke gate's rivals of ``learned`` (beyond ``no_packing``)
RIVALS = ("ttl", "packcache", "dp_greedy")


def stress_trace(profile: str, seed: int, n_requests: int):
    """One non-stationary trace; content is seed-determined, only arrival
    times differ across profiles (inverse-CDF warp of the same draws)."""
    return synth_trace(SynthConfig(
        kind="netflix", n_items=N_ITEMS, n_servers=N_SERVERS,
        n_requests=n_requests, t_max=TIME_PER_REQUEST * n_requests,
        bundle_cover=1.0, bundle_zipf=0.7, server_affinity=2,
        load_profile=profile, load_strength=SCENARIOS[profile],
        load_peak=0.4, seed=seed,
    ))


def env_for(cost_model: str, params: CostParams) -> CacheEnvironment | None:
    """Pricing environment per model: homogeneous Table-I, or skewed
    per-server prices + lognormal item sizes for ``heterogeneous``."""
    if cost_model == "heterogeneous":
        return CacheEnvironment.skewed(
            N_ITEMS, N_SERVERS, params, price_sigma=0.8, size_sigma=0.5,
            seed=1)
    return None


def policy_kwargs(name: str, t_cg: float, lp) -> dict:
    if name in ("no_packing", "dp_greedy"):
        return {}
    if name == "learned":
        return dict(t_cg=t_cg, learned=lp)
    return dict(t_cg=t_cg)


def run_grid(n_requests: int, eval_seeds=EVAL_SEEDS,
             scenarios=tuple(SCENARIOS), models=MODELS,
             policies=POLICIES, device=None) -> dict:
    """Train per (scenario, model), then rank the policies over the
    eval-seed shard axis in one sweep on ``device``."""
    missing = set(policies) - set(list_policies())
    if missing:
        raise ValueError(f"not registered: {sorted(missing)}")
    params = CostParams(rho=4.0)
    pts, keys = [], []
    for cm in models:
        env = env_for(cm, params)
        for profile in scenarios:
            train_tr = stress_trace(profile, TRAIN_SEED, n_requests)
            tcg = t_cg_for(train_tr, params, env=env, cost_model=cm)
            lp = train_policy(train_tr, env=env, t_cg=tcg, params=params,
                              cost_model=cm, device=device)
            shards = tuple(stress_trace(profile, s, n_requests)
                           for s in eval_seeds)
            for name in policies:
                pts.append(SweepPoint(
                    name, shards,
                    dict(params=params, env=env, cost_model=cm,
                         **policy_kwargs(name, tcg, lp)),
                    tag=f"{profile}/{cm}"))
                keys.append((profile, cm, name))

    res = SweepEngine(device=device).run(pts)
    payload: dict = {
        "n_requests": n_requests, "rho": params.rho,
        "eval_seeds": list(eval_seeds), "device": str(device or "cuda"),
        "grid": {},
    }
    for (profile, cm, name), r in zip(keys, res):
        cell = payload["grid"].setdefault(f"{profile}/{cm}", {})
        cell[name] = {
            "total": r.costs.total, "transfer": r.costs.transfer,
            "caching": r.costs.caching, "shard_stats": r.shard_stats,
        }
    for cell in payload["grid"].values():
        ranking = sorted(policies, key=lambda p: cell[p]["total"])
        cell["ranking"] = ranking
        cell["learned_rank"] = ranking.index("learned") + 1
        cell["learned_vs_no_packing_saving_pct"] = round(
            100.0 * (1.0 - cell["learned"]["total"]
                     / cell["no_packing"]["total"]), 2)
    return payload


def smoke(device=None) -> int:
    """The gate on regime_shift x table1 (module docstring)."""
    n_requests, eval_seeds = 2500, (101, 102)
    params = CostParams(rho=4.0)
    train_tr = stress_trace("regime_shift", TRAIN_SEED, n_requests)
    tcg = t_cg_for(train_tr, params, cost_model="table1")
    lp = train_policy(train_tr, t_cg=tcg, params=params, device=device)

    shards = tuple(stress_trace("regime_shift", s, n_requests)
                   for s in eval_seeds)
    pts = [SweepPoint(name, shards,
                      dict(params=params, **policy_kwargs(name, tcg, lp)))
           for name in ("no_packing", *RIVALS, "learned")]
    res = {p.policy: r
           for p, r in zip(pts, SweepEngine(device=device).run(pts))}
    totals = {k: r.costs.total for k, r in res.items()}
    print("fig11 --smoke: " + " ".join(
        f"{k}={v:.0f}" for k, v in sorted(totals.items(),
                                          key=lambda kv: kv[1])))
    if totals["learned"] >= totals["no_packing"]:
        print("FAIL: trained policy does not beat no_packing on the "
              "regime-shift stress trace")
        return 1
    if not any(totals["learned"] < totals[r] for r in RIVALS):
        print(f"FAIL: trained policy beats none of {RIVALS}")
        return 1

    cpu = sum(run_policy(
        get_policy("learned", params=params, t_cg=tcg, learned=lp), tr,
        device="cpu").costs.total for tr in shards)
    print(f"fig11 --smoke: parity sweep={totals['learned']:.9f} "
          f"cpu={cpu:.9f}")
    if abs(totals["learned"] - cpu) > 1e-9 * max(abs(cpu), 1.0):
        print("FAIL: the sweep's learned replay and the CPU replay disagree")
        return 1
    print("OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6000)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    payload = run_grid(args.requests, device=args.device)
    rows = []
    for key, cell in payload["grid"].items():
        rows.append((
            f"fig11/{key}", 0,
            "rank=" + ">".join(cell["ranking"])
            + f";learned_saving={cell['learned_vs_no_packing_saving_pct']}%",
        ))
    save_json("BENCH_learned_torch", payload)
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
