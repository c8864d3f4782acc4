#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--requests 1000000]

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds the CUDA kernels from ``src/repro_torch/csrc`` and holds each
   against its plain PyTorch version, bitwise, at the main path's shapes
   and at ragged ones (merge_density on inputs whose pair densities fall
   on both sides of gamma); times kernel, plain version and library call
   and works out each kernel's bound from the work these inputs need;
3. for each configuration (``netflix-table2``: the paper's Table-II trace,
   60 items x 600 servers; ``catalog-10k``: 10,000 items x 600 servers),
   replays the trace with ``akpc`` through ``run_policy`` on the card,
   checks that every kernel was launched, replays it again with the plain
   versions, and requires equal partitions, equal E/anchor and costs at
   1e-9; a head of the trace also runs on the CPU (the path the tests hold
   against the JAX package's numpy engine) and must agree with the card;
4. prints the kernels' JSON line and, last, the result line.

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

from repro_torch.core import CostParams, get_policy, run_policy  # noqa: E402
from repro_torch.core.cgm_schedule import (  # noqa: E402
    build_cgm_schedule,
    policy_hot_dims,
)
from repro_torch.core.replay import run_policy_torch  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    KERNELS,
    _build,
    clique_pair_edges,
    clique_pair_edges_plain,
    crm_update,
    crm_update_plain,
    merge_density,
    merge_density_plain,
)
from repro_torch.traces import SynthConfig, paper_trace, synth_trace  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): TF32 on the tensor
#: cores (exact for the 0/1 products here: integer sums below 2**24 with
#: fp32 accumulation), fp32 outside the tensor cores, and HBM3 bandwidth
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
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
}
#: requests of each configuration's head that also run on the CPU
HEAD = {"netflix-table2": 20_000, "catalog-10k": 5_000}
#: the replay's named profiler spans (``core/cgm.py``)
SPANS = ("cgm.", "replay.")


def t_cg_for(trace, dt: float = 1.0) -> float:
    """Clique-generation period: a small multiple of the cache TTL dt
    (the formula of the reference's benchmarks; dt = rho lam / mu = 1 at
    the default CostParams)."""
    span = float(trace.times[-1] - trace.times[0])
    return float(min(max(0.3 * dt, span / 50.0), max(span / 4.0, 1e-6)))


def make_trace(config: str, n_requests: int, seed: int):
    if config == "netflix-table2":
        return paper_trace("netflix", n_requests, seed)
    return synth_trace(SynthConfig(
        kind="spotify", n_items=10_000, n_servers=600, n_requests=n_requests,
        t_max=60.0 * n_requests / 1_000_000, bundle_cover=1.0,
        bundle_zipf=0.7, seed=seed))


def akpc(t_cg: float):
    return get_policy("akpc", params=CostParams(), t_cg=t_cg, top_frac=0.1)


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
    for name, count in launches.items():
        if count <= 0:
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


def profile_phase(config: str, trace, t_cg: float, out_dir) -> dict:
    """Where the time goes: one unprofiled replay (wall clock), then the
    same replay under ``torch.profiler`` (device time by kernel, host time
    by span).  The idle share is 1 - device busy time / unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    plain_wall = run_policy(akpc(t_cg), trace).wall_seconds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_policy(akpc(t_cg), trace)
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
    (out_dir / f"profile_{config}.txt").write_text(
        evs.table(sort_by="self_cpu_time_total", row_limit=60))
    print("profile " + json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=1_000_000,
                    help="requests per configuration (cut only this)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also profile a replay of each configuration's "
                    "first N requests (tables under --out)")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the build log and profile tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul allow_tf32=False cudnn allow_tf32=False", flush=True)
    if args.requests != 1_000_000:
        print(f"cut: n_requests {args.requests} per configuration "
              "(n and m unchanged)", flush=True)
    dev = torch.device("cuda")

    configs = {}
    for config in ("netflix-table2", "catalog-10k"):
        t0 = time.perf_counter()
        trace = make_trace(config, args.requests, args.seed)
        t_cg = t_cg_for(trace)
        pol = akpc(t_cg)
        sched = build_cgm_schedule(trace, t_cg, uses_sizes=False,
                                   hot_dims=policy_hot_dims(pol))
        configs[config] = (trace, t_cg, sched.h, sched.wcap)
        print(f"config {config}: n={trace.n} m={trace.m} "
              f"requests={trace.n_requests} t_cg={t_cg} h={sched.h} "
              f"wcap={sched.wcap} windows={sched.boundary_steps.size} "
              f"trace_s={time.perf_counter() - t0:.3f}", flush=True)

    t0 = time.perf_counter()
    info = _build.build_all()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in info["logs"].items()))
    print(f"build: {time.perf_counter() - t0:.2f} s for {info['built']} "
          "(nvcc, sm_90a, in parallel)", flush=True)

    records = kernel_phase({c: (v[2], v[3]) for c, v in configs.items()},
                           args.seed, dev)
    results = {c: slice_phase(c, v[0], v[1]) for c, v in configs.items()}
    if args.profile:
        for c, v in configs.items():
            head = v[0].slice(0, min(args.profile, v[0].n_requests))
            profile_phase(c, head, t_cg_for(head), out_dir)

    main_cfg = "catalog-10k"
    kernels = []
    for name, fn in KERNELS.items():
        rec = dict(records[main_cfg][name])
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": results[main_cfg]["launches"][name],
            **rec,
            "by_config": {c: {**records[c][name],
                              "launches": results[c]["launches"][name]}
                          for c in records},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
