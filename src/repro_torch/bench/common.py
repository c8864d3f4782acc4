"""Shared benchmark machinery of the port (its own copies of the reference's
``benchmarks/common.py`` helpers), and the card's peak rates for bounds.

Times on the card come from CUDA events, over back-to-back calls
(:func:`cuda_time`) or over the replay of a CUDA graph of calls, the
card's time alone (:func:`cuda_graph_time`); a bound is
the least time the card could take for the same work: the larger of the
bytes it must move at the HBM rate and the operations it must do at the
peak rate of their type (:func:`bound`).
"""
from __future__ import annotations

import json
import os

import torch

from ..core.cost import CacheEnvironment, CostParams, get_cost_model

RESULTS_DIR = os.environ.get("REPRO_RESULTS", "experiments/results")
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
