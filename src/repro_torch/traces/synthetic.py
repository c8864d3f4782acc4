"""Synthetic Netflix-like / Spotify-like traces.

The paper evaluates on Kaggle Netflix/Spotify traces (refs [15], [16]) with
synthesised user locations.  Those dumps are not available in this offline
container, so we synthesise traces with the statistics the paper relies on:

* Zipf item/bundle popularity (heavy-tailed access counts, top-10% of items
  carry most of the traffic — the paper filters CRM construction to them);
* SESSION structure: a user at one server consumes several consecutive items
  of one latent bundle (a show season / playlist) in a short burst — this is
  exactly the co-access signal AKPC mines (93%-predictability claim, §I);
* multi-item requests up to d_max (batch arrivals, Table II d_max = 5);
* 600 servers, 1M requests, integer-free float timeline (Table II).

"netflix" = fewer, smaller bundles (seasons of 4-10 episodes), strong binge
sequentiality, shorter sessions.  "spotify" = larger bundles (playlists of
8-20 tracks), longer sessions, slightly noisier.  Generators are fully seeded
and every benchmark records the SynthConfig used.

A copy of ``repro.traces.synthetic``: the same seed gives the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .loader import Trace


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    kind: str = "netflix"            # "netflix" | "spotify"
    n_items: int = 600               # catalog |U| (top-10% -> 60, Table II)
    n_servers: int = 600             # |S| = m (Table II)
    n_requests: int = 1_000_000
    d_max: int = 5                   # max request size (Table II)
    seed: int = 0
    # time model: horizon chosen so hot items re-arrive within ~dt at busy
    # servers (dt = rho*lam/mu = 1 at Table-II defaults)
    t_max: float = 4000.0
    # session model
    mean_session_len: float = 6.0
    intra_gap: float = 0.02          # mean time between session requests
    p_multi: float = 0.45            # P(request has >1 item)
    p_noise: float = 0.05            # P(item replaced by random catalog item)
    bundle_zipf: float = 1.35        # bundle popularity skew (head-heavy,
    #                                  real VoD/music traces concentrate >80%
    #                                  of plays on the top titles)
    server_zipf: float = 0.9         # server load skew
    bundle_cover: float = 0.6        # fraction of catalog covered by bundles
    # regional content affinity: each server's users draw sessions from this
    # many preferred bundles (0 = no affinity, global popularity everywhere).
    # Real CDN edge nodes serve geographically clustered preferences [17-19].
    server_affinity: int = 0
    p_affinity_escape: float = 0.1   # P(session ignores the server preference)
    # per-item sizes (PR 4 CostModel axis): "unit" keeps the paper's
    # unit-size items (Trace.sizes = None); "lognormal" draws mean-1
    # lognormal volumes with log-std size_sigma; "pareto" a heavy tail
    # (think mixed episode lengths / track bitrates)
    size_dist: str = "unit"          # "unit" | "lognormal" | "pareto"
    size_sigma: float = 0.75         # lognormal log-std / pareto tail shape
    # non-stationary request volume (Carlsson & Eager's time-varying
    # arrival model, arXiv 1803.03914): session starts follow a rate
    # profile lambda(t) instead of the uniform (stationary) default.
    # The SAME uniform draws are warped through the inverse CDF of
    # lambda, so request CONTENT (bundles, servers, items) is identical
    # across profiles at a fixed seed — only arrival times shift.
    load_profile: str = "stationary"  # | "diurnal" | "flash_crowd"
    #                                 # | "regime_shift"
    load_strength: float = 0.8       # diurnal amplitude in [0, 1) /
    #                                  flash-crowd peak height (x base) /
    #                                  regime-shift rate ratio
    load_cycles: float = 2.0         # diurnal periods over the horizon
    load_peak: float = 0.5           # crowd centre / shift point (frac of
    #                                  t_max)
    load_width: float = 0.05         # flash-crowd sigma (frac of t_max)

    def bundle_size_range(self) -> tuple[int, int]:
        return (4, 10) if self.kind == "netflix" else (8, 20)


def paper_trace(kind: str, n_requests: int = 1_000_000, seed: int = 0) -> "Trace":
    """Trace matched to the paper's Table-II setup (see EXPERIMENTS.md).

    |U| = 60 items (the paper's universe is the top-10% of the raw dataset,
    so popularity inside it is flat-ish), m = 600 servers, regional content
    affinity, request density such that hot (clique, server) pairs sit at the
    TTL crossover — the regime the paper's cost dynamics live in.
    """
    dense_tmax = 6.0 * n_requests / 100_000.0
    if kind == "netflix":
        cfg = SynthConfig(
            kind="netflix", n_items=60, n_servers=600, n_requests=n_requests,
            t_max=dense_tmax, bundle_cover=1.0, bundle_zipf=0.7,
            server_affinity=2, mean_session_len=6.0, seed=seed,
        )
    elif kind == "spotify":
        cfg = SynthConfig(
            kind="spotify", n_items=60, n_servers=600, n_requests=n_requests,
            t_max=dense_tmax, bundle_cover=1.0, bundle_zipf=0.6,
            server_affinity=2, mean_session_len=10.0, p_multi=0.5, seed=seed,
        )
    else:
        raise ValueError(f"unknown paper trace kind: {kind}")
    return synth_trace(cfg)


def _item_sizes(cfg: SynthConfig, rng: np.random.Generator) -> np.ndarray | None:
    """Per-item volumes for the size-aware cost models (mean ~1)."""
    if cfg.size_dist == "unit":
        return None
    if cfg.size_dist == "lognormal":
        sig = cfg.size_sigma
        return np.exp(rng.normal(-0.5 * sig**2, sig, cfg.n_items))
    if cfg.size_dist == "pareto":
        a = max(1.0 + 1.0 / max(cfg.size_sigma, 1e-6), 1.05)
        raw = 1.0 + rng.pareto(a, cfg.n_items)       # Lomax + 1, support >= 1
        return raw / raw.mean()
    raise ValueError(f"unknown size_dist: {cfg.size_dist!r}")


def load_rate(cfg: SynthConfig, t: np.ndarray) -> np.ndarray:
    """Arrival-rate profile lambda(t) on [0, t_max] (mean-level ~1).

    * ``diurnal`` — sinusoidal day/night cycle (``load_cycles`` periods,
      amplitude ``load_strength``);
    * ``flash_crowd`` — Gaussian surge of height ``load_strength`` x base
      at ``load_peak``, width ``load_width`` (viral content / live event);
    * ``regime_shift`` — base rate jumps by factor ``load_strength`` at
      ``load_peak`` (catalog launch / market shift).
    """
    t = np.asarray(t, np.float64)
    x = t / max(cfg.t_max, 1e-12)
    if cfg.load_profile == "stationary":
        return np.ones_like(t)
    if cfg.load_profile == "diurnal":
        a = min(max(cfg.load_strength, 0.0), 0.999)
        return 1.0 + a * np.sin(2.0 * np.pi * cfg.load_cycles * x)
    if cfg.load_profile == "flash_crowd":
        w = max(cfg.load_width, 1e-6)
        return 1.0 + cfg.load_strength * np.exp(
            -0.5 * ((x - cfg.load_peak) / w) ** 2)
    if cfg.load_profile == "regime_shift":
        return np.where(x < cfg.load_peak, 1.0, cfg.load_strength)
    raise ValueError(f"unknown load_profile: {cfg.load_profile!r}")


def _warp_times(cfg: SynthConfig, u: np.ndarray) -> np.ndarray:
    """Uniform draws -> arrival times under ``load_rate`` via the inverse
    CDF (dense-grid trapezoid + interp); stationary profiles pass through
    as ``u * t_max``, matching the legacy uniform draw exactly."""
    if cfg.load_profile == "stationary":
        return u * cfg.t_max
    grid = np.linspace(0.0, cfg.t_max, 4097)
    lam = load_rate(cfg, grid)
    cdf = np.concatenate([
        [0.0], np.cumsum(0.5 * (lam[1:] + lam[:-1]) * np.diff(grid))])
    cdf /= cdf[-1]
    return np.interp(u, cdf, grid)


def _zipf_choice(rng: np.random.Generator, n: int, s: float, size: int) -> np.ndarray:
    """Zipf(s)-distributed choices over [0, n) (rank 0 = most popular)."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    w /= w.sum()
    return rng.choice(n, size=size, p=w)


def synth_trace(cfg: SynthConfig) -> Trace:
    rng = np.random.default_rng(cfg.seed)

    # --- latent bundles over a contiguous hot region of the catalog -------
    lo, hi = cfg.bundle_size_range()
    covered = int(cfg.n_items * cfg.bundle_cover)
    # running total, NOT `while sum(sizes) < covered`: re-summing the
    # list is O(B^2) and dominated generation at n_items >= 10^4 (~14k
    # bundles at n=10^5).  Draw sequence is unchanged, so seeded traces
    # stay bitwise identical.
    sizes: list[int] = []
    covered_so_far = 0
    while covered_so_far < covered:
        sz = int(rng.integers(lo, hi + 1))
        sizes.append(sz)
        covered_so_far += sz
    starts = np.cumsum([0] + sizes[:-1])
    sizes_a = np.array(sizes)
    starts = starts[starts + sizes_a <= cfg.n_items]
    sizes_a = sizes_a[: len(starts)]
    n_bundles = len(starts)

    # --- sessions ----------------------------------------------------------
    n_sessions = int(cfg.n_requests / cfg.mean_session_len * 1.3) + 8
    sess_len = rng.geometric(1.0 / cfg.mean_session_len, size=n_sessions)
    sess_len = np.clip(sess_len, 1, 4 * int(cfg.mean_session_len))
    total = np.cumsum(sess_len)
    n_sessions = int(np.searchsorted(total, cfg.n_requests) + 1)
    sess_len = sess_len[:n_sessions]
    R = int(sess_len.sum())

    sess_server = _zipf_choice(rng, cfg.n_servers, cfg.server_zipf, n_sessions)
    if cfg.server_affinity > 0 and n_bundles > cfg.server_affinity:
        # each server prefers a few bundles (sampled by global popularity)
        a = min(cfg.server_affinity, n_bundles)
        wb = 1.0 / np.arange(1, n_bundles + 1) ** cfg.bundle_zipf
        wb /= wb.sum()
        prefs = np.stack(
            [
                rng.choice(n_bundles, size=a, replace=False, p=wb)
                for _ in range(cfg.n_servers)
            ]
        )                                               # (m, a)
        pick = rng.integers(0, a, size=n_sessions)
        sess_bundle = prefs[sess_server, pick]
        escape = rng.random(n_sessions) < cfg.p_affinity_escape
        n_esc = int(escape.sum())
        if n_esc:
            sess_bundle[escape] = _zipf_choice(rng, n_bundles, cfg.bundle_zipf, n_esc)
    else:
        sess_bundle = _zipf_choice(rng, n_bundles, cfg.bundle_zipf, n_sessions)
    if cfg.load_profile == "stationary":
        sess_start = rng.uniform(0.0, cfg.t_max, size=n_sessions)
    else:
        # same rng consumption as the stationary draw: content identical
        # across profiles at a fixed seed, only arrival times warp
        sess_start = _warp_times(
            cfg, rng.uniform(0.0, 1.0, size=n_sessions))

    # expand per-request arrays
    req_sess = np.repeat(np.arange(n_sessions), sess_len)
    req_bundle = sess_bundle[req_sess]
    servers = sess_server[req_sess].astype(np.int32)
    # position of the request within its session
    pos = np.arange(R) - np.repeat(np.cumsum(sess_len) - sess_len, sess_len)
    gaps = rng.exponential(cfg.intra_gap, size=R)
    # per-session cumulative offsets
    cum = np.cumsum(gaps)
    base = np.repeat(cum[np.cumsum(sess_len) - sess_len], sess_len)
    times = sess_start[req_sess] + (cum - base)

    # --- items: random subsets of the session's bundle ---------------------
    # Users consume several items of one latent bundle per session in varied
    # order (binge with skips / shuffled playlist) — over a window this makes
    # the intra-bundle CRM a dense BLOCK, the structure K-cliques mine.
    del pos
    b_start = starts[req_bundle]
    b_size = sizes_a[req_bundle]
    n_it = np.ones(R, dtype=np.int64)
    multi = rng.random(R) < cfg.p_multi
    n_it[multi] = rng.integers(2, cfg.d_max + 1, size=int(multi.sum()))
    n_it = np.minimum(n_it, b_size)
    max_b = int(sizes_a.max())
    u = rng.random((R, max_b))
    u[np.arange(max_b)[None, :] >= b_size[:, None]] = np.inf  # invalid slots
    pick = np.argsort(u, axis=1)[:, : cfg.d_max]              # k-subset w/o repl.
    cols = np.arange(cfg.d_max)[None, :]
    items = (b_start[:, None] + pick).astype(np.int32)
    items[cols >= n_it[:, None]] = -1

    # --- noise: replace kept items with random catalog items ---------------
    keep = items >= 0
    noise = (rng.random(items.shape) < cfg.p_noise) & keep
    items[noise] = rng.integers(0, cfg.n_items, size=int(noise.sum())).astype(np.int32)

    # de-duplicate within a request (sets): sort row, mask repeats
    items_sorted = np.sort(items, axis=1)[:, ::-1]     # -1 pads go last
    dup = np.zeros_like(items_sorted, dtype=bool)
    dup[:, 1:] = (items_sorted[:, 1:] == items_sorted[:, :-1]) & (
        items_sorted[:, 1:] >= 0
    )
    items_sorted[dup] = -1
    items = np.sort(items_sorted, axis=1)[:, ::-1]

    # --- sort by time, truncate -------------------------------------------
    order = np.argsort(times, kind="stable")[: cfg.n_requests]
    # sizes come from a DERIVED rng so the request stream is identical across
    # size_dist settings (same seed -> same requests, only sizes differ)
    sizes = _item_sizes(cfg, np.random.default_rng((cfg.seed, 0x517E)))
    return Trace(
        times=times[order],
        servers=servers[order],
        items=items[order],
        n=cfg.n_items,
        m=cfg.n_servers,
        name=f"{cfg.kind}-synth-s{cfg.seed}",
        sizes=sizes,
    )
