"""granite-moe-3b-a800m's decode step on the card: its time, its kernels
and its host share.

    python -m repro_torch.bench.decode_bench

Builds the full config (32 layers) with seeded weights and a zero cache
of CACHE positions for BATCH rows, and runs STEPS decode steps at
position CACHE // 2 after three of warm-up.  Prints one ``decode_bench
{json}`` line: the step in ms by CUDA events (median and min), the host
ms of issuing a step (the wall of the call, no sync), and, from one more
step under ``torch.profiler``, the kernels a step and the device-busy ms
(the union of the kernels' intervals).  A decode step whose device-busy
ms is far under its event ms is held back by the host.

The imports are absolute, so the file run by its path with another
checkout's ``src`` on ``PYTHONPATH`` times that checkout's model code: two
commits compared on one card in one call.  Needs CUDA.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.common import dtype_of

ARCH, BATCH, CACHE, STEPS, SEED = "granite_moe_3b_a800m", 8, 512, 60, 0


def device_busy(fn) -> tuple[int, float]:
    """``fn()`` under ``torch.profiler``: (kernels launched, device-busy
    ms), copies and memsets left out of the count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e.start_ns(), e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, -1
    for s, e, _ in ev:
        busy += max(0, e - max(s, end))
        end = max(end, e)
    kernels = sum(1 for *_, n in ev if not n.startswith(("Memcpy", "Memset")))
    return kernels, busy / 1e6


def bench() -> dict:
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cuda")
    params = model.init(SEED)
    cache = model.init_cache(BATCH, CACHE, dtype_of(cfg.compute_dtype))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, 1)).astype(np.int32)).cuda()
    pos = CACHE // 2

    def step():
        return model.decode_step(params, cache, tokens, pos)

    for _ in range(3):
        step()
    ms, host = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step()
        stop.record()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    kernels, busy = device_busy(step)
    return {"arch": ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "batch": BATCH, "cache": CACHE, "steps": STEPS,
            "step_ms_median": float(np.median(ms)),
            "step_ms_min": float(np.min(ms)),
            "host_ms_median": float(np.median(host)),
            "kernels_a_step": kernels, "device_busy_ms": busy}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench: CUDA is not available")
    with torch.no_grad():
        line = bench()
    print("decode_bench " + json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
