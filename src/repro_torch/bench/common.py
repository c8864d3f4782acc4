"""Shared benchmark machinery of the port (its own copies of the reference's
``benchmarks/common.py`` helpers), and the card's peak rates for bounds.

The figure drivers replay the same seeded synthetic traces as the
reference (:func:`get_trace` / :func:`get_trace_shards`) through the Fig.-5
method set (:func:`method_policies`), one serial ``run_policy`` per method
(:func:`run_methods`) or one :class:`~repro_torch.core.sweep.SweepEngine`
call for a whole grid (:func:`run_method_grid`), with the OPT lower bound
beside them; each returns the reference's payload shape.  Budget knobs are
the reference's environment variables: ``REPRO_BENCH_REQUESTS`` (fig5),
``REPRO_BENCH_SWEEP_REQUESTS`` (a sweep point) and ``REPRO_BENCH_SHARDS``.

Times on the card come from CUDA events, over back-to-back calls
(:func:`cuda_time`) or over the replay of a CUDA graph of calls, the
card's time alone (:func:`cuda_graph_time`); a bound is
the least time the card could take for the same work: the larger of the
bytes it must move at the HBM rate and the operations it must do at the
peak rate of their type (:func:`bound`).
"""
from __future__ import annotations

import functools
import json
import os
import time

import numpy as np
import torch

from ..core.cost import CacheEnvironment, CostParams, get_cost_model
from ..traces import paper_trace

RESULTS_DIR = os.environ.get("REPRO_RESULTS", "experiments/results")
N_REQUESTS = int(os.environ.get("REPRO_BENCH_REQUESTS", "150000"))
N_SWEEP = int(os.environ.get("REPRO_BENCH_SWEEP_REQUESTS", "40000"))
#: >1 splits each figure's request budget over per-seed trace replicas
#: (the sweep's trace-shard axis), so figures report mean +- 95% CI
N_SHARDS = int(os.environ.get("REPRO_BENCH_SHARDS", "1"))
#: H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): TF32 on the tensor
#: cores (exact for the 0/1 products here: integer sums below 2**24 with
#: fp32 accumulation), fp32 and fp64 outside the tensor cores (the scans'
#: float64 comparisons count at the fp64 rate), and HBM3 bandwidth
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12


def emit(rows: list[tuple]) -> None:
    """CSV to stdout: name,us_per_call,derived."""
    for name, us, derived in rows:
        print(f"{name},{us},{derived}")


def save_json(name: str, payload) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def t_cg_for(trace, params: CostParams | None = None,
             env: CacheEnvironment | None = None,
             cost_model: str = "table1") -> float:
    """Clique-generation period: a small multiple of the cache TTL dt (max
    over servers under heterogeneous prices), as the reference's figure
    benchmarks set it."""
    if env is None:
        env = CacheEnvironment(trace.n, trace.m, params or CostParams())
    dt = float(get_cost_model(cost_model, env).dt().max())
    span = float(trace.times[-1] - trace.times[0])
    return float(min(max(0.3 * dt, span / 50.0), max(span / 4.0, 1e-6)))


@functools.lru_cache(maxsize=8)
def get_trace(kind: str, n_requests: int, seed: int = 0):
    return paper_trace(kind, n_requests=n_requests, seed=seed)


@functools.lru_cache(maxsize=8)
def get_trace_shards(kind: str, n_requests: int, shards: int | None = None,
                     seed0: int = 0):
    """The figure workload as a trace-shard tuple (or one trace).

    ``shards`` defaults to ``REPRO_BENCH_SHARDS``; above 1 the request
    budget splits across per-seed replicas that replay as extra lanes of
    one sweep call, so every :func:`run_method_grid` entry gains
    ``shard_stats``.  At 1 this is :func:`get_trace`."""
    k = N_SHARDS if shards is None else int(shards)
    if k <= 1:
        return get_trace(kind, n_requests, seed0)
    return tuple(
        paper_trace(kind, n_requests=max(1, n_requests // k),
                    seed=seed0 + i)
        for i in range(k))


def method_policies(params: CostParams, t_cg: float, top_frac: float) -> dict:
    """Fig.-5 method set as (registry name -> policy kwargs); ``params``
    is the reference's signature (no method's kwargs read it)."""
    del params
    return {
        "no_packing": {},
        "ttl": dict(t_cg=t_cg),
        "learned": dict(t_cg=t_cg),   # warm-start scorer (no trained params)
        "dp_greedy": dict(top_frac=top_frac),
        "packcache": dict(t_cg=t_cg, top_frac=top_frac),
        "akpc_base": dict(t_cg=t_cg, top_frac=top_frac),
        "akpc": dict(t_cg=t_cg, top_frac=top_frac),
    }


def _result_entry(res) -> dict:
    """One method's payload entry from a RunResult (the serial
    :func:`run_methods` and the swept :func:`run_method_grid` emit the
    same JSON shape)."""
    entry = {
        "total": res.total,
        "transfer": res.costs.transfer,
        "caching": res.costs.caching,
        "seconds": round(res.wall_seconds, 2),
    }
    if (res.clique_sizes > 1).any():
        entry["clique_sizes"] = np.bincount(res.clique_sizes).tolist()
    if getattr(res, "shard_stats", None):
        entry["shard_stats"] = res.shard_stats
    return entry


def _maybe_add_opt(out: dict, trace, params, env, cost_model, methods) -> None:
    """Attach the OPT lower bound when requested and valid for the model;
    for a trace-shard tuple, the sum of the per-shard bounds (as the
    sweep sums the policies' shard costs)."""
    from ..core.baselines import OPT_BOUND_MODELS, opt_lower_bound

    if methods is not None and "opt" not in methods:
        return
    if cost_model not in OPT_BOUND_MODELS:
        return                  # e.g. tiered: compare against no_packing
    t0 = time.perf_counter()
    shards = trace if isinstance(trace, (list, tuple)) else (trace,)
    totals = np.zeros(3, np.float64)
    for tr in shards:
        costs = opt_lower_bound(tr, params, env=env, cost_model=cost_model)
        totals += (costs.total, costs.transfer, costs.caching)
    out["opt"] = {
        "total": float(totals[0]),
        "transfer": float(totals[1]),
        "caching": float(totals[2]),
        "seconds": round(time.perf_counter() - t0, 2),
    }


def run_methods(trace, params: CostParams, methods=None, top_frac: float = 1.0,
                env: CacheEnvironment | None = None,
                cost_model: str = "table1", device=None) -> dict:
    """``{method: {total, transfer, caching, seconds}}``: one serial
    ``run_policy`` per method on ``device`` (default CUDA), under the
    pricing scenario ``env`` / ``cost_model``, plus the OPT bound."""
    from ..core.policy import get_policy, run_policy

    env = CacheEnvironment.resolve(env, trace, params)
    t_cg = t_cg_for(trace, params, env=env, cost_model=cost_model)
    out = {}
    for name, kw in method_policies(params, t_cg, top_frac).items():
        if methods is not None and name not in methods:
            continue
        res = run_policy(
            get_policy(name, params=params, env=env, cost_model=cost_model,
                       **kw),
            trace, device=device)
        out[name] = _result_entry(res)
    _maybe_add_opt(out, trace, params, env, cost_model, methods)
    return out


def run_method_grid(grid: list[dict], backend: str | None = None,
                    layout=None, device=None,
                    stats: dict | None = None) -> list[dict]:
    """Many (trace, params, scenario) points in ONE sweep call.

    Each grid entry takes :func:`run_methods`' keywords (``trace``
    required; ``params``, ``methods``, ``top_frac``, ``env``,
    ``cost_model`` optional, and ``t_cg`` to override the derived
    clique-generation period, as fig8's batch axis does); each returned
    entry has :func:`run_methods`' shape.  The policy replays are one
    :class:`~repro_torch.core.sweep.SweepEngine` run on ``device``:
    ``backend`` ``"torch"`` (the default; the lane-stacked scans) or
    ``"serial"`` (one ``run_policy`` a point); there is no other backend
    and no fallback.  ``layout`` is the state layout (``"bucketed"`` lets
    a mixed-(n, m) grid replay one scan a bucket cohort).  ``stats``, a
    dict, receives the engine's ``last_stats`` (one record a scan under
    ``"groups"``), its wall seconds (``"wall"``) and its schedule count
    (``"schedules"``).  OPT bounds are closed-form, on the host.
    """
    from ..core.sweep import SweepEngine, SweepPoint

    pts, slots, resolved = [], [], []
    for gi, g in enumerate(grid):
        trace = g["trace"]
        # a tuple of traces is the shard axis: the scenario resolves on
        # the first shard
        tr0 = trace[0] if isinstance(trace, (list, tuple)) else trace
        params = g.get("params") or CostParams()
        env = CacheEnvironment.resolve(g.get("env"), tr0, params)
        cost_model = g.get("cost_model", "table1")
        methods = g.get("methods")
        t_cg = g.get("t_cg")
        if t_cg is None:
            t_cg = t_cg_for(tr0, params, env=env, cost_model=cost_model)
        resolved.append((trace, params, env, cost_model, methods))
        for name, kw in method_policies(
                params, t_cg, g.get("top_frac", 1.0)).items():
            if methods is not None and name not in methods:
                continue
            pts.append(SweepPoint(
                name, trace,
                dict(params=params, env=env, cost_model=cost_model, **kw)))
            slots.append(gi)

    eng = SweepEngine(backend=backend or "torch", layout=layout,
                      device=device)
    res = eng.run(pts)
    if stats is not None:
        stats.update(eng.last_stats, wall=eng.last_wall,
                     schedules=eng.last_n_schedules)
    out: list[dict] = [{} for _ in grid]
    for pt, gi, r in zip(pts, slots, res):
        out[gi][pt.policy] = _result_entry(r)
    for gi, (trace, params, env, cost_model, methods) in enumerate(resolved):
        _maybe_add_opt(out[gi], trace, params, env, cost_model, methods)
    return out


def relative_to_opt(res: dict, reference: str = "opt") -> dict:
    """Totals relative to ``reference`` (default: the OPT lower bound).
    Without a valid bound (e.g. tiered pricing) pick the reference
    explicitly, e.g. ``reference="no_packing"``."""
    if reference not in res:
        raise KeyError(
            f"no {reference!r} entry in results (no valid OPT bound for "
            'this cost model?); pass reference="no_packing" explicitly')
    base = res[reference]["total"]
    return {k: round(v["total"] / base, 4) for k, v in res.items()}


def device_arg(ap) -> None:
    """The drivers' ``--device`` option."""
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without it) or cpu")


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


def cuda_graph_time(fn, calls: int, reps: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card alone: a CUDA graph that
    holds ``calls`` calls, replayed ``reps`` times after a warm-up replay,
    by CUDA events, over ``reps * calls``.  Back-to-back eager calls
    (:func:`cuda_time`) read the host's enqueue when a call's kernel is
    shorter than its Python wrapper; a replay launches the captured
    kernels with no host in between.  ``fn`` must not sync (no id check,
    no read back)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * calls)


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
