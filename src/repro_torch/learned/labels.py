"""Hindsight keep/evict labels from cost deltas (the training signal).

A numpy copy of ``repro.learned.labels``, priced through the port's cost
model hooks; the same trace gives the same ``(X, y, w)`` bit for bit.

For every T_CG window ``w`` and item ``i`` the trainer asks: given the
decision the policy must make at the ``w``-boundary, which choice would
the NEXT window's accesses have made cheaper?

* ``cost_evict`` — every access of ``i`` in window ``w+1`` is a forced
  miss priced as a plain (unpacked) transfer, and nothing is ever
  cached: exactly what the engine's keep-or-not mask charges for a
  "nokeep" item (``ReplayEngine.set_item_keep``).
* ``cost_keep`` — mirrors the engine's Alg.-6 ANCHOR semantics and its
  charged (non-hypothetical) cost fields: the copy at the item's anchor
  server (the server of its most recent access) never truly expires —
  a lapsed anchor copy is ratcheted forward in ``dt`` steps, so the
  access is a HIT whose charged extension is only
  ``(gap - dt) mod dt`` (the ratchet rent itself lands in the
  diagnostic ``keepalive_rent``, which is NOT part of ``total``).  An
  access within ``dt`` of the same item's previous refresh at that
  server pays extension rent ``rate * gap``; an off-anchor access
  whose server copy lapsed pays a transfer plus the prepaid re-cache
  rent ``rate * dt_j``.  (First access of the window treats the
  boundary as the previous anchor touch — a deliberate window-local
  simplification: carry-over state from window ``w`` is not modeled.)

Both sides are priced through the SAME registered CostModel hooks
(``transfer_cost_batch`` / ``caching_rate`` / ``dt``) the replay engines
use, so labels follow per-server prices and item volumes under the
tiered/heterogeneous models with no extra code.

The label is ``keep iff cost_keep < cost_evict`` and the example weight
is ``|cost_keep - cost_evict|`` — items whose decision is economically
irrelevant (unaccessed next window: both sides 0) drop out of the loss
with weight 0 instead of being filtered.
"""
from __future__ import annotations

import numpy as np

from ..core.cost import CacheEnvironment, CostParams, get_cost_model
from ..core.crm import build_window_crm
from .featurize import features_np, init_stats, update_stats, window_co_degree


def _window_index(times: np.ndarray, t_cg: float) -> np.ndarray:
    """Window id per request, matching the engine's boundary semantics
    (a request exactly AT a boundary opens the next window)."""
    t0 = float(times[0])
    return np.floor((np.asarray(times, np.float64) - t0) / t_cg).astype(
        np.int64)


def hindsight_windows(
    trace,
    env: CacheEnvironment | None = None,
    t_cg: float = 50.0,
    *,
    params: CostParams | None = None,
    cost_model="table1",
    theta: float | None = None,
    top_frac: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replay ``trace``'s windows into (features X, labels y, weights w).

    Returns ``X (N, F) f64``, ``y (N,) f64`` in {0, 1} and ``w (N,) f64``
    with ``N = (n_windows - 1) * n`` — one labeled example per (window,
    item), the last window unlabeled (no hindsight).  Features are built
    with the same :mod:`featurize` machinery the serving policy uses.
    """
    params = params or (env.params if env is not None else CostParams())
    env = CacheEnvironment.resolve(env, trace, params)
    model = get_cost_model(cost_model, env)
    theta = params.theta if theta is None else theta
    dt_j = np.asarray(model.dt(), np.float64)        # (m,)
    dt_s = float(dt_j.max())
    sizes = env.sizes()
    n, t_cg = trace.n, float(t_cg)
    items2d = trace.items if trace.items.ndim == 2 else trace.items[:, None]
    widx = _window_index(trace.times, t_cg)
    W = int(widx[-1]) + 1
    t0 = float(trace.times[0])

    stats = init_stats(n, dt_s)
    ones_n = np.ones(n, np.float64)
    X_parts, y_parts, w_parts = [], [], []
    for w in range(W - 1):
        sel = widx == w
        it_w = items2d[sel]
        flat = it_w[it_w >= 0]
        counts = np.bincount(flat, minlength=n).astype(np.float64)
        crm = build_window_crm(it_w, n, theta, top_frac) if flat.size else None
        boundary = t0 + (w + 1) * t_cg
        update_stats(stats, counts, boundary, t_cg)
        X_parts.append(features_np(
            counts, window_co_degree(crm, n), stats, sizes, ones_n,
            boundary, dt_s, t_cg))

        # -- hindsight costs from window w+1 -----------------------------
        nxt = np.nonzero(widx == w + 1)[0]
        evict_c = np.zeros(n, np.float64)
        keep_c = np.zeros(n, np.float64)
        if nxt.size:
            it_n = items2d[nxt]
            valid = it_n >= 0
            rr, cc = np.nonzero(valid)
            it = it_n[rr, cc].astype(np.int64)
            tt = np.asarray(trace.times, np.float64)[nxt][rr]
            sv = np.asarray(trace.servers, np.int64)[nxt][rr]
            # anchor order: per item, by time
            oa = np.lexsort((tt, it))
            it, tt, sv = it[oa], tt[oa], sv[oa]
            first = np.ones(it.size, bool)
            first[1:] = it[1:] != it[:-1]
            prev_t = np.empty_like(tt)
            prev_t[first] = boundary
            prev_t[~first] = tt[np.nonzero(~first)[0] - 1]
            prev_sv = np.full(it.size, -1, np.int64)
            prev_sv[~first] = sv[np.nonzero(~first)[0] - 1]
            gap = np.maximum(tt - prev_t, 0.0)
            # per-(item, server) order: gap since this server's own copy
            # was last refreshed (inf = not refreshed this window)
            ob = np.lexsort((tt, sv, it))
            first_js = np.ones(it.size, bool)
            first_js[1:] = (it[ob][1:] != it[ob][:-1]) | (
                sv[ob][1:] != sv[ob][:-1])
            gap_js = np.full(it.size, np.inf)
            nf = np.nonzero(~first_js)[0]
            gap_js[ob[nf]] = tt[ob[nf]] - tt[ob[nf - 1]]
            one = np.ones(it.size, np.int64)
            trans = np.asarray(model.transfer_cost_batch(
                one, sizes[it], sv), np.float64)
            rate = np.asarray(model.caching_rate(
                one, sizes[it], sv), np.float64)
            dt_acc = dt_j[sv]
            # anchor access (same server as previous, or window-first):
            # always a hit — fresh pays extension rent over the gap,
            # lapsed pays only the ratchet remainder (gap - dt) mod dt.
            # Off-anchor: own-copy extension rent within TTL, else a
            # transfer plus the prepaid re-cache rent dt_j.
            at_anchor = first | (sv == prev_sv)
            ratchet = np.mod(np.maximum(gap - dt_acc, 0.0), dt_acc)
            anchor_cost = rate * np.where(gap <= dt_acc, gap, ratchet)
            keep_cost = np.where(
                at_anchor, anchor_cost,
                np.where(gap_js <= dt_acc, rate * gap_js,
                         trans + rate * dt_acc))
            np.add.at(evict_c, it, trans)
            np.add.at(keep_c, it, keep_cost)
        y_parts.append((keep_c < evict_c).astype(np.float64))
        w_parts.append(np.abs(evict_c - keep_c))

    if not X_parts:
        F = features_np(ones_n, ones_n, stats, sizes, ones_n,
                        t0, dt_s, t_cg).shape[1]
        return (np.zeros((0, F)), np.zeros(0), np.zeros(0))
    return (np.concatenate(X_parts, axis=0),
            np.concatenate(y_parts),
            np.concatenate(w_parts))
