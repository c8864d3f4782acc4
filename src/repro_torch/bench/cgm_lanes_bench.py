"""One lane of the laned device clique generation against the unlaned one.

    python -m repro_torch.bench.cgm_lanes_bench [--requests 1000000]

The device clique generation has two implementations: the unlaned
:func:`~repro_torch.core.cgm.run_cgm_schedule` (``replay_cgm``, the
streaming session, the live engine and the cache consumers) and the laned
:func:`~repro_torch.core.cgm_lanes.run_cgm_lanes` (a sweep's device-CGM
super-groups).  This bench replays each configuration of
``chip_smoke.py``'s ``slice`` phase (``akpc`` at top_frac 0.1 over
``netflix-table2`` and ``catalog-10k``) through both, the laned one at one
lane, on the same schedule and carry, in turns (unlaned, laned, laned,
unlaned), on the card: both must give the same slot maps, ``E``, anchors
and cost accumulator bit for bit (``E`` and anchors without their dump
row, which takes the writes of inert events in any order).  It prints one
JSON line a configuration: the four walls (host clock ending in a device
sync) and the host syncs of each.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import CacheEnvironment, CacheState, CliquePartition, CostParams
from ..core import get_policy
from ..core.cgm import init_cgm_carry, run_cgm_schedule
from ..core.cgm_lanes import (
    SHARED_KEYS,
    init_lane_carry,
    run_cgm_lanes,
    stack_cspecs,
)
from ..core.cgm_schedule import build_cgm_schedule, cgm_spec, policy_hot_dims
from ..core.replay import TorchReplayEngine, resolve_device
from ..traces import SynthConfig, paper_trace, synth_trace
from .common import t_cg_for

CONFIGS = ("netflix-table2", "catalog-10k")


def make_trace(config: str, n_requests: int, seed: int = 0):
    """``chip_smoke.py``'s trace of the configuration."""
    if config == "netflix-table2":
        return paper_trace("netflix", n_requests, seed)
    return synth_trace(SynthConfig(
        kind="spotify", n_items=10_000, n_servers=600, n_requests=n_requests,
        t_max=60.0 * n_requests / 1_000_000, bundle_cover=1.0,
        bundle_zipf=0.7, seed=seed))


def compare(config: str, n_requests: int, device) -> dict:
    """Both implementations on one configuration, in turns."""
    tr = make_trace(config, n_requests)
    t_cg = t_cg_for(tr)
    pol = get_policy("akpc", params=CostParams(), t_cg=t_cg, top_frac=0.1)
    pol.bind(tr.n, tr.m)
    env = CacheEnvironment.resolve(None, tr, pol.params)
    jeng = TorchReplayEngine(tr.n, tr.m, pol.params, env=env, device=device)
    sched = build_cgm_schedule(tr, t_cg, uses_sizes=False,
                               batch_size=pol.batch_size,
                               hot_dims=policy_hot_dims(pol))
    cspec = cgm_spec(pol.config, pol.config.params, tr.n)
    state = CacheState.fresh(CliquePartition.singletons(tr.n), tr.m)
    spec = {k: np.stack([np.asarray(v)]) for k, v in jeng._spec.items()}

    def unlaned():
        c0 = init_cgm_carry(state, None, None, schedule=sched,
                            uses_sizes=False, item_sizes=None, device=device)
        final, ofs, stats = run_cgm_schedule(
            sched, jeng._spec, jeng._statics, cspec, c0, None)
        return final, ofs, stats

    def laned():
        c0 = init_lane_carry(state, 1, schedule=sched, uses_sizes=False,
                             item_sizes=None, device=device)
        final, ofs, stats = run_cgm_lanes(
            sched, spec, jeng._statics, stack_cspecs([cspec]), c0, None)
        return {k: v if k in SHARED_KEYS else v[0]
                for k, v in final.items()}, ofs[0], stats

    walls, syncs, outs = {"unlaned": [], "laned": []}, {}, {}
    for name in ("unlaned", "laned", "laned", "unlaned"):
        fn = unlaned if name == "unlaned" else laned
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        final, ofs, stats = fn()
        # the last row of E and anchor is the dump row: not state
        host = {k: final[k][:tr.n].cpu().numpy() for k in ("E", "anchor")}
        host["acc"] = final["acc"].cpu().numpy()
        host["ofs"] = ofs.cpu().numpy()
        walls[name].append(time.perf_counter() - t0)
        syncs[name] = {k: v for k, v in stats.items() if k.startswith("sync")}
        outs.setdefault(name, host)
    a, b = outs["unlaned"], outs["laned"]
    equal = all(np.array_equal(a[k], b[k]) for k in a)
    if not equal:
        raise AssertionError(f"{config}: the laned run at one lane differs "
                             "from the unlaned run")
    return {"config": config, "requests": tr.n_requests,
            "windows": int(sched.boundary_steps.size), "equal": equal,
            "unlaned_walls_s": walls["unlaned"],
            "laned_walls_s": walls["laned"], "syncs": syncs,
            "device": torch.cuda.get_device_name(device)}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    device = resolve_device(None)
    out = []
    for config in CONFIGS:
        rec = compare(config, args.requests, device)
        print("cgm_lanes_bench " + json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
