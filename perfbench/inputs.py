"""A run's inputs, made from ``--seed`` and the cell's files alone.

The request streams come from the benchmark's frozen generator
(:mod:`perfbench.synthetic`), the server prices from its frozen copy of
the skewed-price scenario; the program and the reference are handed the
same arrays.
"""
from __future__ import annotations

import numpy as np

from .synthetic import Requests, SynthConfig, synth_trace


def derived_seed(seed: int, *keys: int) -> int:
    """A generator seed from the run's seed (any whole number) and keys."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def requests(gen: dict, n_requests: int, seed: int) -> Requests:
    """``n_requests`` of the configuration's generator: ``gen`` holds
    ``SynthConfig`` fields, with the horizon given as ``time_per_request``
    (the configuration's request density)."""
    g = dict(gen)
    per = float(g.pop("time_per_request"))
    return synth_trace(SynthConfig(**g, n_requests=int(n_requests),
                                   t_max=per * int(n_requests), seed=seed))


def server_prices(pricing: dict, m: int, lam: float, mu: float):
    """(lam_j, mu_j) of a skewed-price scenario, or (None, None): mean
    preserving lognormal prices of sigma ``price_sigma`` drawn from the
    fixed ``price_seed`` (the deployment's price table, the same in every
    run).  Frozen from ``CacheEnvironment.skewed`` (``src/repro_torch/
    core/cost.py`` at commit 63887c5)."""
    sigma = float(pricing.get("price_sigma", 0.0))
    if sigma <= 0.0:
        return None, None
    seed = int(pricing["price_seed"])

    def logn(mean, key):
        rng = np.random.default_rng((seed, key))
        return mean * np.exp(rng.normal(-0.5 * sigma**2, sigma, m))

    return logn(lam, 1), logn(mu, 2)


def max_dt(params: dict, lam_j, mu_j) -> float:
    """The largest per-server TTL extension dt_j = rho * lam_j / mu_j."""
    if lam_j is None:
        return float(params.get("rho", 1.0) * params.get("lam", 1.0)
                     / params.get("mu", 1.0))
    return float((params.get("rho", 1.0) * lam_j / mu_j).max())


def t_cg_for(span: float, dt: float) -> float:
    """The clique-generation period the paper's figures use: a small
    multiple of the largest TTL, clipped to [span / 50, span / 4] of the
    replayed span (frozen from ``src/repro_torch/bench/common.py::
    t_cg_for`` at commit 63887c5)."""
    return float(min(max(0.3 * dt, span / 50.0), max(span / 4.0, 1e-6)))


def grid(spec: list) -> np.ndarray:
    """``[lo, hi, count]`` -> ``count`` evenly spaced values."""
    lo, hi, count = spec
    return np.linspace(float(lo), float(hi), int(count))


def pass_shift(req: Requests) -> float:
    """The time shift between two passes of one stream: a whole number
    past the last request, so pass k + 1 starts after pass k ends."""
    return float(np.floor(req.times[-1]) + 1.0)
