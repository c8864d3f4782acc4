#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--requests 1000000] [--requests2 N]

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and holds the three kernels of the device clique
   generation against their plain PyTorch versions, bitwise, at the main
   path's shapes and at ragged ones; times kernel, plain version and
   library call and works out each kernel's bound from the work these
   inputs need;
3. the AKPC replay with the device clique generation, for each of
   ``netflix-table2`` (the paper's Table-II trace, 60 items x 600 servers)
   and ``catalog-10k`` (10,000 items x 600 servers): ``akpc`` through
   ``run_policy`` on the card, every kernel of the path launched, again
   with the plain versions, equal partitions, E/anchor and costs at 1e-9,
   and a head of the trace on the CPU equal to the card;
4. the host-schedule replay: ``hetero-table2`` (the Table-II trace with
   lognormal item sizes under the heterogeneous cost model, per-server
   dt) with ``akpc``, ``no_packing``, ``ttl``, ``packcache`` and
   ``dp_greedy``; ``hetero-catalog-10k`` with ``akpc``; and ``no_packing``
   under table1 on ``netflix-table2`` (uniform dt: the scan kernels must
   stay idle).  Each run: kernels on the card, every expected kernel
   launched, plain versions on the card (no launch), equal state and
   costs, a CPU head equal to the card's;
5. holds the scan and gather kernels (and the CGM kernels at the host
   clique generation's shapes) against their plain versions on inputs
   captured from those replays and on ragged ones, and times them;
6. prints the kernels' JSON line and, last, the result line.

Exits non-zero without CUDA, and on any failed check or exception.
Writes the kernel build log (and ``--profile`` tables) under ``--out``
(default ``smoke_out/``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    CacheEnvironment,
    CacheState,
    CostParams,
    get_cost_model,
    get_policy,
    run_policy,
)
from repro_torch.core.cgm_schedule import (  # noqa: E402
    build_cgm_schedule,
    policy_hot_dims,
)
from repro_torch.core.replay import (  # noqa: E402
    TorchReplayEngine,
    run_policy_torch,
    run_schedule,
    state_to_device,
)
from repro_torch.kernels import (  # noqa: E402
    KERNELS,
    _build,
    capture,
    clique_pair_edges,
    clique_pair_edges_plain,
    crm_update,
    crm_update_plain,
    merge_density,
    merge_density_plain,
    packed_lookup,
    packed_lookup_plain,
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
)
from repro_torch.traces import SynthConfig, paper_trace, synth_trace  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): TF32 on the tensor
#: cores (exact for the 0/1 products here: integer sums below 2**24 with
#: fp32 accumulation), fp32 and fp64 outside the tensor cores (the scans'
#: float64 comparisons count at the fp64 rate), and HBM3 bandwidth
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
#: (omega, gamma) cases of the merge_density check: the path's default
#: and two that let other pair sizes and every density through
MERGE_CASES = ((5, 0.85), (3, 0.0), (4, 0.6))
SOURCES = {
    "crm_update": ("src/repro_torch/csrc/crm_update.cu",
                   "src/repro/kernels/crm_update.py:45"),
    "clique_pair_edges": ("src/repro_torch/csrc/clique_density.cu",
                          "src/repro/kernels/clique_density.py:41"),
    "merge_density": ("src/repro_torch/csrc/merge_step.cu",
                      "src/repro/kernels/merge_step.py:53"),
    "seg_running_argmax": ("src/repro_torch/csrc/segment_reduce.cu",
                           "src/repro/kernels/segment_reduce.py:108"),
    "seg_running_max": ("src/repro_torch/csrc/segment_reduce.cu",
                        "src/repro/kernels/segment_reduce.py:95"),
    "packed_lookup": ("src/repro_torch/csrc/packed_lookup.cu",
                      "src/repro/kernels/packed_lookup.py:61"),
}
#: the kernels of the AKPC replay with the device clique generation
CGM_KERNELS = ("crm_update", "clique_pair_edges", "merge_density")
#: the scan kernels of the host-schedule replay under per-server dt
SEG_KERNELS = ("seg_running_argmax", "seg_running_max")
#: requests of each configuration's head that also run on the CPU
HEAD = {"netflix-table2": 20_000, "catalog-10k": 5_000,
        "hetero-table2": 20_000, "hetero-catalog-10k": 5_000}
#: fig10's server-price skew (lognormal sigma of lam_j / mu_j) and seed
PRICE_SIGMA = 1.0
PRICE_SEED = 1
#: ragged scan lengths (the replay's step width is about 8192)
RAGGED_L = (1, 7, 8191, 8193, 100_000)
#: the replay's named profiler spans (``core/cgm.py``)
SPANS = ("cgm.", "replay.", "host.")


def t_cg_for(trace, dt: float = 1.0) -> float:
    """Clique-generation period: a small multiple of the cache TTL dt
    (the formula of the reference's benchmarks; dt = rho lam / mu = 1 at
    the default CostParams)."""
    span = float(trace.times[-1] - trace.times[0])
    return float(min(max(0.3 * dt, span / 50.0), max(span / 4.0, 1e-6)))


def make_trace(config: str, n_requests: int, seed: int):
    """The configuration's trace.  ``hetero-*`` take the same request
    stream as their table1 twin with fig10's lognormal item sizes."""
    if config == "netflix-table2":
        return paper_trace("netflix", n_requests, seed)
    if config == "hetero-table2":
        # paper_trace's Table-II SynthConfig with size_dist="lognormal"
        return synth_trace(SynthConfig(
            kind="netflix", n_items=60, n_servers=600, n_requests=n_requests,
            t_max=6.0 * n_requests / 100_000.0, bundle_cover=1.0,
            bundle_zipf=0.7, server_affinity=2, mean_session_len=6.0,
            seed=seed, size_dist="lognormal"))
    return synth_trace(SynthConfig(
        kind="spotify", n_items=10_000, n_servers=600, n_requests=n_requests,
        t_max=60.0 * n_requests / 1_000_000, bundle_cover=1.0,
        bundle_zipf=0.7, seed=seed,
        size_dist="lognormal" if config.startswith("hetero") else "unit"))


def env_for(trace, params: CostParams, price_sigma: float,
            seed: int = PRICE_SEED) -> CacheEnvironment:
    """fig10's environment: lognormal per-server prices from
    ``CacheEnvironment.skewed``, item sizes from the trace."""
    sk = CacheEnvironment.skewed(
        trace.n, trace.m, params, price_sigma=price_sigma, seed=seed)
    return CacheEnvironment.from_trace(
        trace, params, lam_j=sk.lam_j, mu_j=sk.mu_j)


def akpc(t_cg: float):
    return get_policy("akpc", params=CostParams(), t_cg=t_cg, top_frac=0.1)


def host_policy(name: str, t_cg: float, env, cost_model: str):
    """fig5's method set (``benchmarks/common.py::method_policies``) at
    top_frac 0.1, priced by ``cost_model`` in ``env``."""
    kw = {"no_packing": {}, "ttl": dict(t_cg=t_cg),
          "dp_greedy": dict(top_frac=0.1),
          "packcache": dict(t_cg=t_cg, top_frac=0.1),
          "akpc": dict(t_cg=t_cg, top_frac=0.1)}[name]
    return get_policy(name, params=CostParams(), env=env,
                      cost_model=cost_model, **kw)


def cuda_time(fn, reps: int) -> float:
    """Milliseconds per call of ``fn``, by CUDA events over ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def path_inputs(rng, h: int, wcap: int, dev):
    """Inputs at the main path's shapes: a (wcap, h) incidence with <= 5
    hot slots a request row (taken from a (wcap, h+1) buffer as the path
    does), a (2h, h) membership and an (h, h) symmetric binary CRM."""
    Hbuf = torch.zeros((wcap, h + 1), dtype=torch.float32)
    cols = torch.from_numpy(rng.integers(0, h + 1, size=(wcap, 5)))
    Hbuf[torch.arange(wcap)[:, None].expand(wcap, 5), cols] = 1.0
    S = 2 * h
    M = torch.zeros((S, h), dtype=torch.float32)
    grp = torch.from_numpy(rng.integers(0, h, size=h))
    M[grp, torch.arange(h)] = 1.0
    A = torch.from_numpy(rng.random((h, h)) < 0.05)
    A = (torch.triu(A, 1) | torch.triu(A, 1).T).to(torch.float32)
    return Hbuf.to(dev)[:, :h], M.to(dev), A.to(dev)


def dense_inputs(rng, h: int, dev):
    """A (2h, h) membership with the h slots in h // 2 groups and an
    (h, h) CRM at edge density 0.9: pair densities spread across gamma,
    so merge_density's arithmetic decides which entries pass."""
    S = 2 * h
    M = torch.zeros((S, h), dtype=torch.float32)
    grp = torch.from_numpy(rng.integers(0, max(2, h // 2), size=h))
    M[grp, torch.arange(h)] = 1.0
    A = torch.from_numpy(rng.random((h, h)) < 0.9)
    A = (torch.triu(A, 1) | torch.triu(A, 1).T).to(torch.float32)
    return M.to(dev), A.to(dev)


def product_ops(L: torch.Tensor, R: torch.Tensor) -> float:
    """Multiply-adds (x2) that ``L @ R`` needs at these inputs: each k
    pairs its nonzeros of column k of L with those of row k of R."""
    return 2.0 * float(((L != 0).sum(dim=0, dtype=torch.float64)
                        * (R != 0).sum(dim=1, dtype=torch.float64)).sum())


def bound(ops: float, peak_ops: float, nbytes: float) -> dict:
    """Least time for ``ops`` at ``peak_ops`` and ``nbytes`` at HBM rate."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def kernel_phase(shapes: dict, seed: int, dev) -> dict:
    """Build, check and time every kernel at each configuration's shapes
    plus ragged ones; returns per-kernel timing records by configuration."""
    rng = np.random.default_rng(seed)
    records: dict = {}
    ragged = {"ragged": (37, 1001), "ragged-wide": (1000, 3333)}
    report = []
    for label, (h, wcap) in {**shapes, **ragged}.items():
        H, M, A = path_inputs(rng, h, wcap, dev)
        S = 2 * h
        Md, Ad = dense_inputs(rng, h, dev)
        X = clique_pair_edges_plain(Md, Ad)
        sizes = Md.sum(dim=1).to(torch.int32)
        passing = {}
        for omega, g in MERGE_CASES:
            g32 = float(np.float32(g))
            want = merge_density_plain(X, sizes, omega, g32)
            if not ((want >= 0).any() and (want < 0).any()):
                raise AssertionError(
                    f"merge_density check at {label} (omega={omega}, "
                    f"gamma={g}) has no pair on one side of the gate")
            if not torch.equal(merge_density(X, sizes, omega, g32), want):
                raise AssertionError(
                    f"merge_density differs from its plain version at "
                    f"{label} (h={h}, omega={omega}, gamma={g})")
            passing[f"omega={omega} gamma={g}"] = int((want >= 0).sum())
        if not torch.equal(clique_pair_edges(Md, Ad), X):
            raise AssertionError(f"clique_pair_edges differs from its plain "
                                 f"version at {label} (dense A)")
        gamma = float(np.float32(0.85))
        cases = {
            "crm_update": (lambda: crm_update(H), lambda: crm_update_plain(H),
                           lambda: H.T @ H),
            "clique_pair_edges": (lambda: clique_pair_edges(M, A),
                                  lambda: clique_pair_edges_plain(M, A),
                                  lambda: M @ A @ M.T),
            "merge_density": (lambda: merge_density(X, sizes, 5, gamma),
                              lambda: merge_density_plain(X, sizes, 5, gamma),
                              None),
        }
        for name, (kern, plain, lib) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            err = float((got - want).abs().max())
            report.append({"kernel": name, "shapes": label, "h": h,
                           "wcap": wcap, "equal": equal})
            if name == "merge_density":
                report[-1]["passing_pairs"] = passing
            if not equal:
                raise AssertionError(
                    f"{name} differs from its plain version at {label} "
                    f"(h={h}, wcap={wcap}): max abs err {err}")
            if label in ragged:
                continue
            if name == "crm_update":
                bnd = bound(product_ops(H.T, H), PEAK_TF32,
                            4.0 * (wcap * h + h * h))
            elif name == "clique_pair_edges":
                bnd = bound(product_ops(M, A) + product_ops(M @ A, M.T),
                            PEAK_TF32, 4.0 * (S * h + h * h + S * S))
            else:
                bnd = bound(6.0 * S * S, PEAK_FP32, 4.0 * (2 * S * S + S))
            reps = 10 if name != "merge_density" else 100
            records.setdefault(label, {})[name] = {
                "shape": {"h": h, "wcap": wcap, "S": S},
                "max_abs_err": err,
                "ms": cuda_time(kern, reps),
                "plain_ms": cuda_time(plain, reps),
                "library_ms": cuda_time(lib, reps) if lib else None,
                **bnd,
            }
    print("kernels " + json.dumps(report), flush=True)
    return records


def same_state(a, b) -> None:
    if not np.array_equal(a.partition.clique_of, b.partition.clique_of):
        raise AssertionError("final partitions differ")
    if not (np.array_equal(a.E, b.E) and np.array_equal(a.anchor, b.anchor)):
        raise AssertionError("final E/anchor differ")


def same_costs(a, b) -> None:
    da, db = a.costs.as_dict(), b.costs.as_dict()
    for k in ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred"):
        if da[k] != db[k]:
            raise AssertionError(f"{k}: {da[k]} != {db[k]}")
    for k in ("transfer", "caching", "keepalive_rent", "total"):
        if not np.isclose(da[k], db[k], rtol=1e-9, atol=0.0):
            raise AssertionError(f"{k}: {da[k]} != {db[k]} at 1e-9")


def slice_phase(config: str, trace, t_cg: float) -> dict:
    """The main path on the card, its plain-version twin and a CPU head."""
    head = trace.slice(0, min(HEAD[config], trace.n_requests))
    t_head = t_cg_for(head)
    gpu_head = run_policy(akpc(t_head), head)
    cpu_head = run_policy(akpc(t_head), head, device="cpu")
    if gpu_head.n_windows < 2:
        raise AssertionError(f"{config}: the CPU check's head has "
                             f"{gpu_head.n_windows} windows")
    same_state(gpu_head.state, cpu_head.state)
    same_costs(gpu_head, cpu_head)

    for fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    res = run_policy(akpc(t_cg), trace)
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    for name in CGM_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{config}: kernel {name} never launched")
    plain = run_policy_torch(akpc(t_cg), trace, use_kernels=False)
    if any(fn.launches != launches[name] for name, fn in KERNELS.items()):
        raise AssertionError("the plain run launched a kernel")
    same_state(res.state, plain.state)
    same_costs(res, plain)
    total = res.total
    if not (np.isfinite(total) and total > 0.0):
        raise AssertionError(f"total cost {total} is not a positive number")
    if res.costs.n_requests != trace.n_requests or res.n_windows < 2:
        raise AssertionError("the replay did not cover the trace's windows")
    sizes = res.clique_sizes
    out = {
        "config": config, "n": trace.n, "m": trace.m,
        "requests": trace.n_requests, "t_cg": t_cg,
        "windows": res.n_windows, "total_cost": total,
        "transfer": res.transfer, "caching": res.caching,
        "cliques": int(sizes.size), "max_clique": int(sizes.max()),
        "wall_s": res.wall_seconds,
        "requests_per_s": trace.n_requests / res.wall_seconds,
        "plain_wall_s": plain.wall_seconds,
        "loop_stats": res.loop_stats, "launches": launches,
        "cpu_head_requests": head.n_requests,
        "cpu_head_windows": cpu_head.n_windows,
    }
    print("slice " + json.dumps(out), flush=True)
    return out


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def sync_check(pol, trace) -> int:
    """Replay ``trace`` once through the engine to get its schedule, then
    run the scan alone again under ``torch.cuda.set_sync_debug_mode
    ("error")``: any host sync in the loop raises.  Returns its steps."""
    env = CacheEnvironment.resolve(pol.env, trace, pol.params)
    pol.bind(trace.n, trace.m)
    eng = TorchReplayEngine(trace.n, trace.m, pol.params, env=env,
                            cost_model=pol.cost_model,
                            caching_charge=pol.caching_charge)
    part0 = pol.initial_partition(trace)
    if part0 is not None:
        eng.install_partition(part0, now=0.0)
    eng.replay(trace, clique_generator=pol.on_window if pol.t_cg else None,
               t_cg=pol.t_cg)
    E0, a0 = state_to_device(CacheState.fresh(
        eng.last_schedule.partition0, trace.m), trace.n, eng.device)
    stats: dict = {}
    run_schedule(eng.last_schedule, eng._spec, eng._statics, E0, a0,
                 charge=eng.engine.caching_charge, stats=stats,
                 check_syncs=True)
    torch.cuda.synchronize()
    return stats["steps"]


def slice2_phase(config: str, trace, names, cost_model: str,
                 capture_name: str | None = None) -> tuple[dict, dict]:
    """The host-schedule replay of each policy: a CPU head equal to the
    card's, the card run (expected kernels launched), the plain-version
    run on the card (no launch, equal state and costs).  Returns the
    ``slice2`` records by policy and the inputs captured from the run of
    ``capture_name``."""
    params = CostParams()

    def env_of(tr):
        if cost_model == "heterogeneous":
            return env_for(tr, params, PRICE_SIGMA)
        return CacheEnvironment.from_trace(tr, params)

    env = env_of(trace)
    dt = np.asarray(get_cost_model(cost_model, env).dt(), np.float64)
    per_server = bool((dt != dt[0]).any())
    t_cg = t_cg_for(trace, float(dt.max()))
    head = trace.slice(0, min(HEAD[config], trace.n_requests))
    env_h = env_of(head)
    t_head = t_cg_for(head, float(dt.max()))
    out, captured = {}, {}
    for name in names:
        t0 = time.perf_counter()
        gpu_head = run_policy(host_policy(name, t_head, env_h, cost_model),
                              head)
        cpu_head = run_policy(host_policy(name, t_head, env_h, cost_model),
                              head, device="cpu")
        pol = host_policy(name, t_head, env_h, cost_model)
        if pol.t_cg is not None and gpu_head.n_windows < 2:
            raise AssertionError(f"{config}/{name}: the CPU check's head "
                                 f"has {gpu_head.n_windows} windows")
        same_state(gpu_head.state, cpu_head.state)
        same_costs(gpu_head, cpu_head)
        sync_steps = sync_check(pol, head)

        reset_launches()
        if name == capture_name:
            capture.INPUTS = {}
        torch.cuda.synchronize()
        res = run_policy(host_policy(name, t_cg, env, cost_model), trace)
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        if name == capture_name:
            captured = {k: v[1] for k, v in capture.INPUTS.items()}
            capture.INPUTS = None
        expect = ["packed_lookup"] + (list(SEG_KERNELS) if per_server
                                      else [])
        if name == "akpc":
            expect += ["crm_update", "clique_pair_edges"]
        for k in expect:
            if launches[k] <= 0:
                raise AssertionError(f"{config}/{name}: kernel {k} never "
                                     "launched")
        if not per_server and any(launches[k] for k in SEG_KERNELS):
            raise AssertionError(f"{config}/{name}: a scan kernel launched "
                                 "at a uniform dt")
        if res.loop_stats.get("path") != "host_schedule":
            raise AssertionError(f"{config}/{name} did not take the "
                                 "host-schedule replay")
        plain = run_policy_torch(host_policy(name, t_cg, env, cost_model),
                                 trace, use_kernels=False)
        if any(fn.launches != launches[k] for k, fn in KERNELS.items()):
            raise AssertionError("the plain run launched a kernel")
        same_state(res.state, plain.state)
        same_costs(res, plain)
        total = res.total
        if not (np.isfinite(total) and total > 0.0):
            raise AssertionError(f"total cost {total} is not positive")
        if res.costs.n_requests != trace.n_requests:
            raise AssertionError("the replay did not cover the trace")
        st = res.loop_stats
        sizes = res.clique_sizes
        line = {
            "config": config, "policy": name, "cost_model": cost_model,
            "per_server_dt": per_server, "n": trace.n, "m": trace.m,
            "requests": trace.n_requests, "t_cg": t_cg,
            "windows": res.n_windows, "total_cost": total,
            "transfer": res.transfer, "caching": res.caching,
            "cliques": int(sizes.size), "max_clique": int(sizes.max()),
            "wall_s": res.wall_seconds,
            "requests_per_s": trace.n_requests / res.wall_seconds,
            "schedule_s": st["schedule_s"], "cg_seconds": st["cg_s"],
            "lookup_s": st["lookup_s"], "lookup_calls": st["lookup_calls"],
            "schedule_rest_s": st["schedule_rest_s"],
            "scan_s": st["scan_s"], "steps": st["steps"],
            "installs": st["installs"], "nb": st["nb"], "ne": st["ne"],
            "sync_scan": st["sync_scan"], "sync_final": st["sync_final"],
            "sync_checked_steps": sync_steps,
            "launches": launches, "plain_wall_s": plain.wall_seconds,
            "cpu_head_requests": head.n_requests,
            "cpu_head_windows": cpu_head.n_windows,
            "phase_s": time.perf_counter() - t0,
        }
        print("slice2 " + json.dumps(line), flush=True)
        out[name] = line
    return out, captured


def scan_inputs(rng, L: int, starts: str, dev):
    """Ragged scan inputs: values from a few integers (ties everywhere)
    with -inf entries; starts all, first only, or random at p."""
    v = rng.integers(0, 4, size=L).astype(np.float64)
    v[rng.random(L) < 0.1] = -np.inf
    if starts == "all":
        s = np.ones(L, bool)
    elif starts == "first":
        s = np.zeros(L, bool)
        s[0] = True
    else:
        s = rng.random(L) < float(starts)
    return (torch.from_numpy(v).to(dev), torch.from_numpy(s).to(dev))


def _equal(got, want) -> tuple[bool, float]:
    """Bitwise equality and max abs error of a tensor or a tuple of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    eq = all(torch.equal(a, b) for a, b in zip(got, want))
    err = 0.0
    for a, b in zip(got, want):
        if a.numel():
            d = (a.to(torch.float64) - b.to(torch.float64)).abs()
            d = torch.nan_to_num(d, nan=0.0)   # -inf - -inf at equal bits
            err = max(err, float(d.max()))
    return eq, err


def kernel_phase2(captured: dict, seed: int, dev) -> dict:
    """The scan and gather kernels, and the CGM kernels at the host clique
    generation's shapes: bitwise against their plain versions on inputs
    captured from the replays and on ragged ones; timed on the captured
    inputs.  Returns timing records by kernel and configuration."""
    rng = np.random.default_rng(seed)
    report, records = [], {}

    def held(name, label, kern, plain):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        eq, err = _equal(got, want)
        report.append({"kernel": name, "inputs": label, "equal": eq})
        if not eq:
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"{label}: max abs err {err}")
        return err

    for L in RAGGED_L:
        for starts in ("all", "first", "0.01", "0.5"):
            v, s = scan_inputs(rng, L, starts, dev)
            label = f"ragged L={L} starts={starts}"
            held("seg_running_argmax", label,
                 lambda: seg_running_argmax(v, s),
                 lambda: seg_running_argmax_plain(v, s))
            held("seg_running_max", label, lambda: seg_running_max(v, s),
                 lambda: seg_running_max_plain(v, s))
    for (C, om, d, R, dtype) in ((4096, 5, 128, 4096, torch.float32),
                                 (4096, 5, 128, 777, torch.float64),
                                 (61, 1, 1, 9999, torch.int32),
                                 (7, 3, 5, 1, torch.int32)):
        table = torch.from_numpy(rng.standard_normal((C, om, d)) * 100).to(
            dtype).to(dev)
        ids = torch.from_numpy(rng.integers(0, C, size=R).astype(
            np.int32)).to(dev)
        held("packed_lookup", f"ragged ({C}, {om}, {d}) {dtype} R={R}",
             lambda: packed_lookup(table, ids),
             lambda: packed_lookup_plain(table, ids))

    for cfg, cap in captured.items():
        cases = {}
        if "seg_running_argmax" in cap:
            v, s = cap["seg_running_argmax"]
            L = int(v.shape[0])
            cases["seg_running_argmax"] = (
                lambda v=v, s=s: seg_running_argmax(v, s),
                lambda v=v, s=s: seg_running_argmax_plain(v, s), None,
                bound(float(L), PEAK_FP64, L * (8.0 + 1 + 8 + 4)),
                {"L": L, "segments": int(s.sum())})
        if "seg_running_max" in cap:
            v, s = cap["seg_running_max"]
            L = int(v.shape[0])
            cases["seg_running_max"] = (
                lambda v=v, s=s: seg_running_max(v, s),
                lambda v=v, s=s: seg_running_max_plain(v, s), None,
                bound(float(L), PEAK_FP64, L * (8.0 + 1 + 8)),
                {"L": L, "segments": int(s.sum())})
        if "packed_lookup" in cap:
            clique_of, items = cap["packed_lookup"]
            table = torch.from_numpy(clique_of.astype(np.int32)).reshape(
                -1, 1, 1).to(dev)
            ids = torch.from_numpy(np.maximum(items, 0).reshape(-1).astype(
                np.int32)).to(dev)
            R = int(ids.shape[0])
            cases["packed_lookup"] = (
                lambda t=table, i=ids: packed_lookup(t, i, ids_checked=True),
                lambda t=table, i=ids: packed_lookup_plain(t, i),
                lambda t=table, i=ids: t.index_select(0, i),
                bound(0.0, PEAK_FP32, 4.0 * R + 2 * 4.0 * R),
                {"C": int(table.shape[0]), "R": R})
        if "crm_update" in cap:
            (H,) = cap["crm_update"]
            Hd = torch.from_numpy(H).to(dev)
            rows, h = Hd.shape
            cases["crm_update"] = (
                lambda H=Hd: crm_update(H), lambda H=Hd: crm_update_plain(H),
                lambda H=Hd: H.T @ H,
                bound(product_ops(Hd.T, Hd), PEAK_TF32,
                      4.0 * (rows * h + h * h)),
                {"rows": int(rows), "h": int(h)})
        if "clique_pair_edges" in cap:
            M, A = cap["clique_pair_edges"]
            Md, Ad = torch.from_numpy(M).to(dev), torch.from_numpy(A).to(dev)
            S, h = Md.shape
            cases["clique_pair_edges"] = (
                lambda M=Md, A=Ad: clique_pair_edges(M, A),
                lambda M=Md, A=Ad: clique_pair_edges_plain(M, A),
                lambda M=Md, A=Ad: M @ A @ M.T,
                bound(product_ops(Md, Ad) + product_ops(Md @ Ad, Md.T),
                      PEAK_TF32, 4.0 * (S * h + h * h + S * S)),
                {"S": int(S), "h": int(h)})
        for name, (kern, plain, lib, bnd, shape) in cases.items():
            err = held(name, f"captured {cfg}", kern, plain)
            reps = 10 if name in CGM_KERNELS else 100
            records.setdefault(name, {})[cfg] = {
                "shape": shape, "max_abs_err": err,
                "ms": cuda_time(kern, reps),
                "plain_ms": cuda_time(plain, reps),
                "library_ms": cuda_time(lib, reps) if lib else None,
                **bnd,
            }
    print("kernels2 " + json.dumps(report), flush=True)
    return records


def profile_phase(config: str, trace, make_policy, out_dir) -> dict:
    """Where the time goes: one unprofiled replay (wall clock), then the
    same replay under ``torch.profiler`` (device time by kernel, host time
    by span).  The idle share is 1 - device busy time / unprofiled wall.
    ``make_policy()`` gives a fresh policy for each replay."""
    from torch.profiler import ProfilerActivity, profile

    plain_wall = run_policy(make_policy(), trace).wall_seconds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_policy(make_policy(), trace)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    device: dict = {}         # kernels and copies on the device
    span_device: dict = {}    # device-side extent of each named span
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        into = span_device if e.name.startswith(SPANS) else device
        into[e.name] = into.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(device.values()) / 1e3
    spans: dict = {}          # host time inside each named span
    for e in evs:
        if e.key.startswith(SPANS):
            spans[e.key] = spans.get(e.key, 0.0) + e.cpu_time_total / 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "config": config, "requests": trace.n_requests,
        "wall_ms": plain_wall * 1e3,
        "profiled_wall_ms": res.wall_seconds * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (plain_wall * 1e3),
        "span_host_ms": spans,
        "span_device_ms": {k: v / 1e3 for k, v in span_device.items()},
        "launches_total": sum(e.count for e in evs
                              if e.key == "cudaLaunchKernel"),
        "device_kernels": len(device),
        "top_device_ms": {k[:60]: v / 1e3 for k, v in top},
        "loop_stats": res.loop_stats,
    }
    (out_dir / f"profile_{config.replace('/', '_')}.txt").write_text(
        evs.table(sort_by="self_cpu_time_total", row_limit=60))
    print("profile " + json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=1_000_000,
                    help="requests of each AKPC device-CGM configuration "
                    "(cut only this)")
    ap.add_argument("--requests2", type=int, default=1_000_000,
                    help="requests of each host-schedule configuration")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also profile the akpc replay of each device-CGM "
                    "configuration's first N requests (tables under --out)")
    ap.add_argument("--profile2", type=int, default=0, metavar="N",
                    help="the same for the host-schedule akpc replay of "
                    "each hetero configuration")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the build log and profile tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul allow_tf32=False cudnn allow_tf32=False", flush=True)
    for flag, n in (("requests", args.requests),
                    ("requests2", args.requests2)):
        if n != 1_000_000:
            print(f"cut: --{flag} {n} per configuration (n and m "
                  "unchanged)", flush=True)
    dev = torch.device("cuda")
    phases: dict = {}

    def phase(name, t0):
        phases[name] = time.perf_counter() - t0
        print(f"phase {name}: {phases[name]:.3f} s", flush=True)

    t0 = time.perf_counter()
    configs = {}
    for config in ("netflix-table2", "catalog-10k"):
        trace = make_trace(config, args.requests, args.seed)
        t_cg = t_cg_for(trace)
        pol = akpc(t_cg)
        sched = build_cgm_schedule(trace, t_cg, uses_sizes=False,
                                   hot_dims=policy_hot_dims(pol))
        configs[config] = (trace, t_cg, sched.h, sched.wcap)
        print(f"config {config}: n={trace.n} m={trace.m} "
              f"requests={trace.n_requests} t_cg={t_cg} h={sched.h} "
              f"wcap={sched.wcap} windows={sched.boundary_steps.size}",
              flush=True)
    traces2 = {c: make_trace(c, args.requests2, args.seed)
               for c in ("hetero-table2", "hetero-catalog-10k")}
    traces2["netflix-table2"] = (
        configs["netflix-table2"][0] if args.requests2 == args.requests
        else make_trace("netflix-table2", args.requests2, args.seed))
    phase("traces", t0)

    t0 = time.perf_counter()
    info = _build.build_all()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in info["logs"].items()))
    print(f"build: {time.perf_counter() - t0:.2f} s for {info['built']} "
          "(nvcc, sm_90a, in parallel)", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    records = kernel_phase({c: (v[2], v[3]) for c, v in configs.items()},
                           args.seed, dev)
    phase("kernels_cgm", t0)
    results = {}
    for c, v in configs.items():
        t0 = time.perf_counter()
        results[c] = slice_phase(c, v[0], v[1])
        phase(f"slice1 {c}", t0)

    results2, captured = {}, {}
    plan = (("hetero-table2", ("akpc", "no_packing", "ttl", "packcache",
                               "dp_greedy"), "heterogeneous"),
            ("hetero-catalog-10k", ("akpc",), "heterogeneous"),
            ("netflix-table2", ("no_packing",), "table1"))
    for c, names, cost_model in plan:
        t0 = time.perf_counter()
        key = c if cost_model == "heterogeneous" else f"{c}/table1"
        results2[key], cap = slice2_phase(
            c, traces2[c], names, cost_model, capture_name=names[0])
        if cost_model == "heterogeneous":
            captured[c] = cap
        phase(f"slice2 {key}", t0)

    t0 = time.perf_counter()
    records2 = kernel_phase2(captured, args.seed, dev)
    phase("kernels_host_path", t0)
    t0 = time.perf_counter()
    if args.profile:
        for c, v in configs.items():
            head = v[0].slice(0, min(args.profile, v[0].n_requests))
            t_head = t_cg_for(head)
            profile_phase(c, head, lambda: akpc(t_head), out_dir)
    if args.profile2:
        for c in ("hetero-table2", "hetero-catalog-10k"):
            tr = traces2[c]
            head = tr.slice(0, min(args.profile2, tr.n_requests))
            env = env_for(head, CostParams(), PRICE_SIGMA)
            dt_max = float(get_cost_model("heterogeneous", env).dt().max())
            t_head = t_cg_for(head, dt_max)
            profile_phase(c, head, lambda: host_policy(
                "akpc", t_head, env, "heterogeneous"), out_dir)
    if args.profile or args.profile2:
        phase("profile", t0)

    main_cfg, main_cfg2 = "catalog-10k", "hetero-table2"
    kernels = []
    for name in KERNELS:
        src, replaces = SOURCES[name]
        if name in CGM_KERNELS:
            rec = dict(records[main_cfg][name])
            launches = results[main_cfg]["launches"][name]
            by_config = {c: {**records[c][name],
                             "launches": results[c]["launches"][name]}
                         for c in records}
            for c, rec2 in records2.get(name, {}).items():
                by_config[f"{c} host CGM"] = {
                    **rec2, "launches": results2[c]["akpc"]["launches"][name]}
        else:
            rec = dict(records2[name][main_cfg2])
            launches = results2[main_cfg2]["akpc"]["launches"][name]
            by_config = {c: {**r, "launches":
                             results2[c]["akpc"]["launches"][name]}
                         for c, r in records2[name].items()}
            for key, runs in results2.items():
                for pol, line in runs.items():
                    by_config.setdefault(f"{key} {pol}", {})["launches"] = \
                        line["launches"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, **rec,
            "by_config": by_config,
        })
    print(f"phase total: {time.perf_counter() - t_all:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
