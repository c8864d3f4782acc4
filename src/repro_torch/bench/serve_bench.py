"""Sustained serving throughput: the live engine against the streamed session.

The port of ``benchmarks/serve_bench.py``.  A serving front end sees
requests in small arrival slices (a routing step, an RPC burst), and the
cache layer is on the path of every one.  Each scenario streams a
Table-II trace at serving density (60 items x 240 servers, ``t_max`` 6 per
10^5 requests, warped through a non-stationary load profile:
``flash_crowd``, ``diurnal``, ``regime_shift``) in 128-request slices
through three engines, ``akpc`` at ``top_frac`` 1.0 (the device clique
generation):

* **session**: :class:`~repro_torch.core.session.CacheSession`, one device
  replay a slice (state up and down every slice);
* **live cold**: the first :class:`~repro_torch.serving.LiveServingEngine`
  of the process (chunks of 65,536 requests, a ring of 6);
* **live warm**: a second one, the steady state of a long-running server.

Before a time counts, each engine's drained totals must equal the
offline replay of the same trace (``run_policy_torch``): floats at 1e-9,
integer counters exact.  The gate is the reference's: the warm live
engine must sustain more requests a second than the streamed session.

    python -m repro_torch.bench.serve_bench [--smoke]

``--smoke`` streams one ``flash_crowd`` scenario of 60,000 requests; the
full run three profiles of 150,000.  Needs CUDA.  Prints one
``serve_bench {json}`` line (times on the host clock, each run ending in
a device sync).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..core import CacheSession, CostParams, get_policy
from ..core.replay import resolve_device, run_policy_torch
from ..serving import LiveServingEngine
from ..traces import SynthConfig, synth_trace
from .common import t_cg_for
from .sweep_bench import same_costs

PROFILES = ("diurnal", "flash_crowd", "regime_shift")
PARAMS = CostParams()
#: requests an arrival slice; the live engines' chunk and ring (the
#: reference bench's)
SLICE, CHUNK, RING = 128, 65_536, 6


def serve_trace(profile: str, n_requests: int, seed: int = 0):
    """The Table-II trace at serving density under a load profile."""
    return synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=240, n_requests=n_requests,
        t_max=6.0 * n_requests / 100_000.0, bundle_cover=1.0,
        bundle_zipf=0.7, server_affinity=2, mean_session_len=6.0,
        seed=seed, load_profile=profile))


def _policy(trace):
    return get_policy("akpc", params=PARAMS, t_cg=t_cg_for(trace, PARAMS),
                      top_frac=1.0)


def stream(sess, trace, slice_n: int) -> float:
    """Feed the trace in arrival slices; seconds until drained and synced."""
    items, servers, times = trace.items, trace.servers, trace.times
    t0 = time.perf_counter()
    for lo in range(0, trace.n_requests, slice_n):
        hi = lo + slice_n
        sess.feed(items[lo:hi], servers[lo:hi], times[lo:hi])
    drain = getattr(sess, "drain", None)
    if drain is not None:
        drain()
    if sess.device.type == "cuda":
        torch.cuda.synchronize(sess.device)
    return time.perf_counter() - t0


def bench_profile(profile: str, n_requests: int, device) -> dict:
    """One scenario: the offline replay, then the three streamed engines,
    each held to the offline totals before its time is kept."""
    trace = serve_trace(profile, n_requests)
    ref = run_policy_torch(_policy(trace), trace, device=device)

    sess = CacheSession(_policy(trace), trace.n, trace.m, device=device)
    t_session = stream(sess, trace, SLICE)
    same_costs(ref, sess, f"{profile}/session")

    runs = {}
    for label in ("cold", "warm"):
        live = LiveServingEngine(_policy(trace), trace.n, trace.m,
                                 chunk_size=CHUNK, ring=RING, device=device)
        t = stream(live, trace, SLICE)
        same_costs(ref, live, f"{profile}/live_{label}")
        runs[label] = (t, live)
    (t_cold, cold), (t_warm, warm) = runs["cold"], runs["warm"]
    return {
        "profile": profile, "n_requests": n_requests, "slice": SLICE,
        "windows": ref.n_windows, "total_cost": ref.total,
        "device_cgm": bool(cold._cgm),
        "session_s": t_session, "live_cold_s": t_cold, "live_warm_s": t_warm,
        "req_per_s_session": n_requests / t_session,
        "req_per_s_live_cold": n_requests / t_cold,
        "req_per_s_live_warm": n_requests / t_warm,
        "s_per_session_feed": t_session / -(-n_requests // SLICE),
        "speedup_warm": t_session / t_warm,
        "chunks": warm.chunks, "ratchets_cold": cold.compiles,
        "ratchets_warm": warm.compiles,
        "loop_stats_warm": warm.loop_stats,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one flash_crowd scenario of 60,000 requests")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    n = 60_000 if args.smoke else 150_000
    profiles = ("flash_crowd",) if args.smoke else PROFILES
    scenarios = [bench_profile(p, n, dev) for p in profiles]
    out = {
        "device": torch.cuda.get_device_name(dev), "smoke": args.smoke,
        "policy": "akpc", "cost_model": "table1", "chunk": CHUNK,
        "ring": RING, "scenarios": scenarios,
    }
    print("serve_bench " + json.dumps(out, default=float), flush=True)
    # the reference's gate: the persistent engine sustains more requests a
    # second than the session on the same arrival stream (warm: the steady
    # state; cold is recorded, not gated)
    for s in scenarios:
        if not s["live_warm_s"] < s["session_s"]:
            raise AssertionError(
                f"{s['profile']}: warm live engine "
                f"({s['req_per_s_live_warm']:.0f} req/s) no faster than the "
                f"session ({s['req_per_s_session']:.0f} req/s)")


if __name__ == "__main__":
    main()
