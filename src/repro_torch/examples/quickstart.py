"""Quickstart: AKPC against every baseline on a synthetic Netflix-like
trace through the policy registry, then the same AKPC run ONLINE through
the streaming ``CacheSession`` (mid-stream costs, no full trace needed).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--requests 50000]
        [--kind netflix|spotify] [--device cpu]

The port of ``examples/quickstart.py``: every replay runs on ``--device``
(default CUDA; AKPC's clique generation on the card, the baselines through
the host schedule's lookups), OPT's lower bound on the host.  ``run``
returns the numbers it prints.
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
from ..traces import paper_trace

#: (label, policy, its knobs): ``t_cg`` stands for the trace's window
RUNS = (
    ("No Packing", "no_packing", {}),
    ("DP_Greedy (offline 2-pack)", "dp_greedy", dict(top_frac=1.0)),
    ("PackCache (online 2-pack)", "packcache", dict(t_cg=None, top_frac=1.0)),
    ("AKPC w/o CS, w/o ACM", "akpc_base", dict(t_cg=None, top_frac=1.0)),
    ("AKPC (proposed)", "akpc", dict(t_cg=None, top_frac=1.0)),
)
CHUNK = 1000


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=50_000)
    ap.add_argument("--kind", default="netflix", choices=["netflix", "spotify"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without it) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The offline runs (each label's ``CostBreakdown``, OPT's among them),
    the streamed AKPC session's running totals and its final total."""
    params = CostParams()                      # paper Table II
    tr = paper_trace(args.kind, n_requests=args.requests)
    print(f"trace: {tr.name}  {tr.n_requests} requests, "
          f"{tr.n} items, {tr.m} servers")

    # the pricing scenario, from the cost-model registry: the paper's
    # Table-I regime is the "table1" model
    env = CacheEnvironment.from_trace(tr, params)
    t_cg = 0.3 * float(get_cost_model("table1", env).dt().max())
    rows = {}
    for label, name, kw in RUNS:
        kw = {k: (t_cg if k == "t_cg" else v) for k, v in kw.items()}
        rows[label] = run_policy(get_policy(name, params=params, **kw), tr,
                                 device=args.device).costs
    rows["OPT (lower bound)"] = opt_lower_bound(tr, params)
    opt = rows["OPT (lower bound)"].total
    print(f"\n{'method':<28s} {'C_T':>10s} {'C_P':>10s} {'total':>10s} "
          f"{'vs OPT':>7s}")
    for name, c in rows.items():
        print(f"{name:<28s} {c.transfer:>10.0f} {c.caching:>10.0f} "
              f"{c.total:>10.0f} {c.total / opt:>7.3f}")
    akpc = rows["AKPC (proposed)"].total
    pc = rows["PackCache (online 2-pack)"].total
    print(f"\nAKPC saves {100 * (1 - akpc / pc):.1f}% vs the best prior "
          f"online method (PackCache).")

    # -- the same AKPC, but ONLINE: stream chunks, read costs mid-flight ----
    sess = CacheSession(
        get_policy("akpc", params=params, t_cg=t_cg, top_frac=1.0), tr.n,
        tr.m, device=args.device)
    print(f"\nstreaming the trace through CacheSession (chunks of {CHUNK}):")
    quarter = max(1, tr.n_requests // 4)
    running = []
    for s in range(0, tr.n_requests, CHUNK):
        costs = sess.feed(tr.items[s:s + CHUNK], tr.servers[s:s + CHUNK],
                          tr.times[s:s + CHUNK])
        if (s // CHUNK) % (quarter // CHUNK + 1) == 0:
            running.append((sess.now, costs.n_requests, costs.total))
            print(f"  t={sess.now:8.2f}  {costs.n_requests:>7d} requests  "
                  f"running total {costs.total:>10.0f}")
    if not np.isclose(sess.costs.total, akpc, rtol=1e-9):
        raise AssertionError(f"streamed total {sess.costs.total} != offline "
                             f"AKPC {akpc}")
    print(f"  final streaming total {sess.costs.total:.0f} == offline AKPC")
    return {"rows": rows, "t_cg": t_cg, "running": running,
            "stream_total": sess.costs.total}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
