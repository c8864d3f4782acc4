"""Per-window, per-item feature extraction for the learned policy.

The port of ``repro.learned.featurize``: the frozen seam between training
and serving.  The trainer (:mod:`repro_torch.learned.train`) and the
serving policy (:mod:`repro_torch.learned.policy`) build their inputs
here, from the same running per-item stats and window summaries.

Two implementations of the same math:

* :func:`features_np` — numpy float64, the canonical path, a copy of the
  reference's.  Keep/evict decisions are made from these features on the
  host for every replay (CPU or card, offline, session or live engine),
  which is what makes cost parity across them exact.
* :func:`features_torch` — the torch twin of the reference's
  ``features_jnp``, on any device; equal to the numpy path to f64
  round-off.

``FEATURE_SCHEMA_VERSION`` tags trained parameter sets; a policy refuses
params whose schema does not match the featurizer it would serve them
with.
"""
from __future__ import annotations

import numpy as np
import torch

#: frozen feature-schema tag, bumped on ANY change to FEATURE_NAMES or
#: the formulas below; LearnedParams carry it and the policy checks it
FEATURE_SCHEMA_VERSION = 1

#: feature column names, in order (F = len(FEATURE_NAMES))
FEATURE_NAMES = (
    "log_window_count",   # log1p(#accesses in the window just ended)
    "recency",            # (now - last-seen boundary) / t_cg, clipped
    "co_degree",          # log1p(binary-CRM row degree in the window)
    "log_size",           # log(item volume)
    "clique_excess",      # log1p(current clique size - 1)
    "gap_ratio",          # EMA inter-arrival estimate / dt, clipped
    "log_total_count",    # log1p(lifetime access count)
)

#: EMA factor for the inter-arrival estimate (higher = more reactive)
EMA_GAP = 0.3

#: clip ceiling for the unbounded ratio features (recency, gap_ratio)
RATIO_CLIP = 8.0


def init_stats(n: int, dt: float) -> dict:
    """Fresh running per-item stats for a catalog of ``n`` items.

    ``last`` is the boundary time of the last window the item appeared
    in (-inf = never seen), ``ema_gap`` an EMA estimate of the item's
    inter-arrival time (seeded at the cache TTL ``dt`` — "unknown items
    re-arrive right at the keep/evict break-even"), ``total`` the
    lifetime access count.  All float64: these arrays travel through
    policy snapshots and must restore bitwise.
    """
    return {
        "last": np.full(n, -np.inf, dtype=np.float64),
        "ema_gap": np.full(n, float(dt), dtype=np.float64),
        "total": np.zeros(n, dtype=np.float64),
    }


def update_stats(stats: dict, counts: np.ndarray, now: float,
                 t_cg: float) -> dict:
    """Fold one finished window into the running stats (in place).

    The window's mean inter-arrival is estimated as ``t_cg / count`` for
    accessed items (count accesses spread over a t_cg-long window) and
    EMA-merged; unaccessed items keep their previous estimate.
    """
    counts = np.asarray(counts, dtype=np.float64)
    acc = counts > 0
    gap_est = t_cg / np.maximum(counts, 1.0)
    stats["ema_gap"] = np.where(
        acc, (1.0 - EMA_GAP) * stats["ema_gap"] + EMA_GAP * gap_est,
        stats["ema_gap"])
    stats["last"] = np.where(acc, float(now), stats["last"])
    stats["total"] = stats["total"] + counts
    return stats


def window_co_degree(crm, n: int) -> np.ndarray:
    """(n,) f64 co-access degree from a window's binary CRM.

    Items outside the CRM's hot set (or windows with no binary edges)
    get degree 0 — the same "cold items carry no co-access signal" rule
    the clique generator applies.
    """
    deg = np.zeros(n, dtype=np.float64)
    if crm is not None and crm.hot_items.size:
        deg[crm.hot_items] = crm.binary.sum(axis=1).astype(np.float64)
    return deg


def features_np(counts, co_deg, stats, sizes, clique_sizes, now: float,
                dt: float, t_cg: float) -> np.ndarray:
    """(n, F) float64 feature matrix — the canonical host path.

    ``counts``/``co_deg`` summarise the window just ended, ``stats`` the
    running history AFTER :func:`update_stats` folded that window in,
    ``clique_sizes`` the per-item size of the item's CURRENT clique.
    """
    counts = np.asarray(counts, dtype=np.float64)
    co_deg = np.asarray(co_deg, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)
    csz = np.asarray(clique_sizes, dtype=np.float64)
    t_cg = max(float(t_cg), 1e-12)
    dt = max(float(dt), 1e-12)
    rec = np.clip((float(now) - stats["last"]) / t_cg, 0.0, RATIO_CLIP)
    gap = np.clip(stats["ema_gap"] / dt, 0.0, RATIO_CLIP)
    return np.stack([
        np.log1p(counts),
        rec,
        np.log1p(co_deg),
        np.log(np.maximum(sizes, 1e-12)),
        np.log1p(np.maximum(csz - 1.0, 0.0)),
        gap,
        np.log1p(stats["total"]),
    ], axis=1)


def features_torch(counts, co_deg, stats, sizes, clique_sizes, now,
                   dt: float, t_cg: float):
    """The torch twin of :func:`features_np` (same math, same order).

    Every input but ``dt`` / ``t_cg`` may be a tensor (``stats`` a dict of
    tensors); the result has their dtype and device.  At f64 it matches
    the numpy path to round-off (tests hold 1e-12 relative).
    """
    t_cg = max(float(t_cg), 1e-12)
    dt = max(float(dt), 1e-12)
    last = stats["last"]
    t_cg_t = torch.full((), t_cg, dtype=last.dtype, device=last.device)
    dt_t = torch.full((), dt, dtype=last.dtype, device=last.device)
    rec = torch.clamp((now - last) / t_cg_t, 0.0, RATIO_CLIP)
    gap = torch.clamp(stats["ema_gap"] / dt_t, 0.0, RATIO_CLIP)
    return torch.stack([
        torch.log1p(counts),
        rec,
        torch.log1p(co_deg),
        torch.log(torch.clamp(sizes, min=1e-12)),
        torch.log1p(torch.clamp(clique_sizes - 1.0, min=0.0)),
        gap,
        torch.log1p(stats["total"]),
    ], dim=1)
