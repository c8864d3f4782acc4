"""Laned device clique generation: S sweep lanes over one CGM schedule.

The lane axis of :mod:`repro_torch.core.cgm`, as the reference's
``jax.vmap`` of ``cgm_jax.run_cgm_schedule`` over ``(spec, cspec,
carry)`` gives it (``in_axes`` 0 for those, the schedule and the item
sizes shared).  A device-CGM super-group of a sweep (AKPC points of one
trace and pricing that differ only in theta / gamma / omega / top_frac,
and in the prices) runs as one call: every kernel launches once a window
for all lanes, and every loop's host sync reads all lanes at once.

* The window buffers (``wbuf``, ``wcnt``, ``seed``, ``wlen``) depend on
  the trace only and are shared; everything that depends on the partition
  carries a leading lane axis: ``E`` (S, n+1, m), ``anchor``, ``of``,
  ``cnt``, ``acc``, the previous window's compact CRM, ``vol``.
* The CGM knobs are per-lane device tensors in the reference's dtypes
  (:func:`cspec_to_device`): theta f32, gamma32 f32, gamma f64, omega
  int64, omega_f f64, top_frac f64, of_catalog bool; each comparison runs
  in the dtype the unlaned path runs it in.
* The data-dependent loops (Alg.-4 removed / added edges, the split
  worklist, the approximate merge) run the largest lane's count of
  iterations; a lane whose own count is spent is masked, and writes of a
  masked lane go to its own dump slot or write back what was there.  Edge
  lists are compacted per lane into a padded capacity (never one
  ``nonzero`` across lanes); the split worklist is a device stack per
  lane.  A loop's host sync reads "any lane still running", so a laned
  window syncs as often as the unlaned window of its slowest lane.

Each lane equals the unlaned :func:`~repro_torch.core.cgm.replay_cgm` of
its point: slot maps at every boundary, ``E`` and anchors float for float,
costs at 1e-9 (the per-lane sums run in another order).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import capture
from ..kernels.clique_density import clique_pair_edges, clique_pair_edges_plain
from ..kernels.crm_update import crm_update, crm_update_plain
from ..kernels.merge_step import merge_density, merge_density_lanes_plain
from .cgm import _accumulate_window, _count, init_cgm_carry
from .cgm_schedule import _F32_EXACT
from .replay import _bucket, _rate_hook, _transfer_hook, lane_spec_to_device

_I64 = torch.int64
_F64 = torch.float64
_F32 = torch.float32
_INT_MAX = torch.iinfo(torch.int64).max
_INT_MIN = torch.iinfo(torch.int64).min

#: the carry entries that the lanes share (the window depends on the
#: trace only)
SHARED_KEYS = ("wbuf", "wcnt", "seed", "wlen")


def _sync_all(stats: dict, kind: str, t: torch.Tensor) -> list:
    """Read a small device tensor on the host in one sync, counted."""
    _count(stats, "sync_" + kind)
    return t.tolist()


# ---------------------------------------------------------------------------
# host seam: knobs, carry, loop capacities
# ---------------------------------------------------------------------------
def stack_cspecs(cspecs: list) -> dict:
    """Per-lane :func:`~repro_torch.core.cgm_schedule.cgm_spec` dicts ->
    one dict of (S,) numpy arrays, each in its spec's dtype."""
    return {k: np.stack([np.asarray(c[k]) for c in cspecs])
            for k in cspecs[0]}


def _prune(cspec: dict) -> np.ndarray:
    """Per lane: does the approximate merge run in the pruning regime
    (``omega > 2`` and ``gamma > (omega - 2) / omega``, in float64)?"""
    om = np.asarray(cspec["omega"], np.int64)
    gam = np.asarray(cspec["gamma"], np.float64)
    return (om > 2) & (gam > (om - 2.0) / om)


def cspec_to_device(cspec: dict, device) -> dict:
    """Stacked knobs -> device tensors in the reference's dtypes, plus
    ``omega32`` (the kernel's int32 omega) and the per-lane ``prune``."""
    def t(k, dtype):
        return torch.as_tensor(np.asarray(cspec[k]), dtype=dtype,
                               device=device)

    return {
        "theta": t("theta", _F32), "gamma32": t("gamma32", _F32),
        "gamma": t("gamma", _F64), "omega": t("omega", _I64),
        "omega32": t("omega", torch.int32), "omega_f": t("omega_f", _F64),
        "top_frac": t("top_frac", _F64), "of_catalog": t("of_catalog",
                                                         torch.bool),
        "prune": torch.as_tensor(_prune(cspec), device=device),
    }


def lane_loop_statics(cspec: dict, carry0: dict, *, enable_acm: bool):
    """``(gcap, full_merge)`` over the lanes, as the reference's
    ``cgm_loop_statics`` under vmap: ``gcap`` from the largest omega and
    initial group, ``full_merge`` if any lane is outside the pruning
    regime."""
    full_merge = bool(enable_acm) and not bool(_prune(cspec).all())
    cnt_max = int(carry0["cnt"].max().item())
    om_max = int(np.asarray(cspec["omega"]).max())
    gcap = _bucket(max(om_max, cnt_max, 2), 8, 8)
    return gcap, full_merge


def init_lane_carry(state, lanes: int, *, schedule, uses_sizes, item_sizes,
                    device) -> dict:
    """The unlaned carry of ``state`` (no previous window, no open
    window), with every partition-dependent entry repeated over
    ``lanes``."""
    one = init_cgm_carry(state, None, None, schedule=schedule,
                         uses_sizes=uses_sizes, item_sizes=item_sizes,
                         device=device)
    return {k: (v if k in SHARED_KEYS else
                v[None].repeat((lanes,) + (1,) * v.dim()))
            for k, v in one.items()}


# ---------------------------------------------------------------------------
# laned compact-space primitives
# ---------------------------------------------------------------------------
def _compact_rows(mask, size, pad=None):
    """Per row: ascending indices of True entries, padded with ``pad``
    (default the row length); entries past ``size`` are dropped."""
    S, n = mask.shape
    pos = torch.cumsum(mask.to(_I64), 1) - 1
    idx = torch.where(mask & (pos < size), pos, size)
    out = torch.full((S, size + 1), n if pad is None else pad, dtype=_I64,
                     device=mask.device)
    out.scatter_(1, idx, torch.arange(n, dtype=_I64,
                                      device=mask.device).expand(S, n))
    return out[:, :size]


def _true_indices(mask, stats, kind):
    """Per lane, the True entries of ``mask`` (S, N) compacted into the
    largest lane's count: ``(idx, live, cmax)``, pads index 0 and are not
    ``live``; and the counts on the host.  One host sync reads every
    lane's count."""
    counts = mask.sum(1)
    host = _sync_all(stats, kind, counts)
    cmax = max(host, default=0)
    idx = _compact_rows(mask, cmax, pad=0)
    live = (torch.arange(cmax, device=mask.device)[None, :]
            < counts[:, None])
    return idx, live, cmax, host


def _lut(idx, n, h):
    """(S, n+1) catalog -> compact slot maps of per-lane index maps ``idx``
    (S, h) (pads = n); unmapped -> -1."""
    S = idx.shape[0]
    lut = torch.full((S, n + 1), -1, dtype=_I64, device=idx.device)
    lut.scatter_(1, idx, torch.arange(h, dtype=_I64,
                                      device=idx.device).expand(S, h))
    lut[:, n] = -1
    return lut


def _sub2(B, idx):
    """``B[l][idx[l]][:, idx[l]]`` for every lane l: (S, k, k)."""
    L = torch.arange(B.shape[0], device=B.device)[:, None, None]
    return B[L, idx[:, :, None], idx[:, None, :]]


def _member_lists(of, n, gcap):
    """(S, n+1, gcap) member lists of every group of every lane."""
    S = of.shape[0]
    dev = of.device
    order = torch.argsort(of, dim=1, stable=True)
    og = of.gather(1, order)
    iota = torch.arange(n, dtype=_I64, device=dev)
    newrun = torch.ones((S, n), dtype=torch.bool, device=dev)
    newrun[:, 1:] = og[:, 1:] != og[:, :-1]
    start = torch.cummax(torch.where(newrun, iota, 0), 1).values
    col = iota - start
    col = torch.where(col < gcap, col, gcap)
    ml = torch.full((S, n + 1, gcap + 1), n, dtype=_I64, device=dev)
    L = torch.arange(S, device=dev)[:, None]
    ml[L, og, col] = order
    return ml[:, :, :gcap].contiguous()


def _dense_rank(keys):
    """Per row, the dense rank of each entry by ascending key."""
    keys = keys.contiguous()
    sk = torch.sort(keys, dim=1, stable=True).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    rnk = torch.cumsum(first.to(_I64), 1) - 1
    return rnk.gather(1, torch.searchsorted(sk, keys))


def _col(v, i):
    """``v[l, i[l]]`` for every lane: (S,)."""
    return v.gather(1, i[:, None])[:, 0]


def _split_sides(W, member, u, v, cap):
    """The unlaned ``_split_sides_compact`` in every lane at once: ``W``
    (S, cap, cap) float64, ``member`` (S, cap), ``u`` / ``v`` (S,)."""
    S = W.shape[0]
    dev = W.device
    zero = torch.zeros((S, cap), dtype=W.dtype, device=dev)
    wl = torch.where((u >= 0)[:, None],
                     W.gather(2, u.clamp(min=0)[:, None, None].expand(
                         S, cap, 1))[:, :, 0], zero)
    wr = torch.where((v >= 0)[:, None],
                     W.gather(2, v.clamp(min=0)[:, None, None].expand(
                         S, cap, 1))[:, :, 0], zero)
    right = torch.arange(cap, device=dev)[None, :] == v[:, None]
    for p in range(cap):
        act = member[:, p] & (u != p) & (v != p)
        go_left = wl[:, p] >= wr[:, p]
        right[:, p] |= act & ~go_left
        colp = W[:, :, p]
        wl = torch.where((act & go_left)[:, None], wl + colp, wl)
        wr = torch.where((act & ~go_left)[:, None], wr + colp, wr)
    return right & member


def _sub_weights(W, lut, mem):
    """(S, g, g) weights of members ``mem`` (S, g) (ids, pads = n)."""
    gh = lut.gather(1, mem)
    ghc = gh.clamp(min=0)
    okw = (gh >= 0)[:, :, None] & (gh >= 0)[:, None, :]
    return torch.where(okw, _sub2(W, ghc), 0.0)


# ---------------------------------------------------------------------------
# Alg. 2 at a boundary
# ---------------------------------------------------------------------------
def _window_crm(carry, cs, *, n, h, wcap, use_kernels):
    """Per lane: hot set -> compact CRM (one laned ``crm_update``) ->
    binarise.  The window's counts and rows are shared."""
    if wcap >= _F32_EXACT:
        raise ValueError(
            f"device CGM window capacity wcap={wcap} reaches the f32 "
            "exact-integer bound 2**24; lower the clique-generation period")
    dev = carry["wcnt"].device
    S = cs["theta"].shape[0]
    counts = carry["wcnt"][:n]
    support = (counts > 0).sum().to(_F64)
    base = torch.where(cs["of_catalog"],
                       torch.tensor(float(n), dtype=_F64, device=dev), support)
    n_hot = torch.round(base * cs["top_frac"]).clamp(min=1).to(_I64)
    order = torch.argsort(-counts, stable=True)      # ties -> low id
    rank = torch.empty(n, dtype=_I64, device=dev)
    rank[order] = torch.arange(n, dtype=_I64, device=dev)
    hot = (rank[None, :] < n_hot[:, None]) & (counts > 0)[None, :]
    hot_idx = _compact_rows(hot, h)
    valid_h = hot_idx < n
    lut = _lut(hot_idx, n, h)

    wbuf = carry["wbuf"]
    dbuf = wbuf.shape[1]
    rowi = torch.arange(wcap, dtype=_I64, device=dev)[:, None].expand(
        wcap, dbuf)
    live = (rowi < carry["wlen"]) & (wbuf >= 0)
    hs = lut[:, torch.where(live, wbuf, n).reshape(-1)].reshape(S, wcap, dbuf)
    hcol = torch.where(hs >= 0, hs, h)
    H = torch.zeros((S, wcap, h + 1), dtype=_F32, device=dev)
    L = torch.arange(S, device=dev)[:, None, None]
    H[L, rowi[None], hcol] = 1.0
    capture.keep_largest("crm_update_lanes", carry["wlen"],
                         lambda: (H.clone()[:, :, :h],))
    raw = (crm_update if use_kernels else crm_update_plain)(H[:, :, :h])
    hi = raw.amax(dim=(1, 2)).to(_F64)[:, None, None]
    norm = torch.where(hi > 0.0, (raw.to(_F64) / hi).to(_F32), 0.0)
    eye = torch.eye(h, dtype=torch.bool, device=dev)
    hm2 = valid_h[:, :, None] & valid_h[:, None, :]
    binary = (norm > cs["theta"][:, None, None]) & hm2 & ~eye
    return hot_idx, valid_h, lut, raw, norm, binary


# ---------------------------------------------------------------------------
# Alg. 4 adjust + Alg. 3 split/merge, laned
# ---------------------------------------------------------------------------
def _adjust_partition(of, gsize, binary, W, hot_idx, lut, addM, remM,
                      rem_map, omega, stats, *, n, h, gcap):
    """``cgm._adjust_partition`` in every lane; the edge loops run the
    largest lane's edge count, a lane past its own count is masked."""
    S = of.shape[0]
    dev = of.device
    L = torch.arange(S, device=dev)
    of = torch.cat([of, of.new_zeros((S, 1))], 1)    # (S, n+1), dump n
    gsize = torch.cat([gsize, gsize.new_zeros((S, 1))], 1)
    ngroups = (gsize[:, :n] > 0).sum(1)
    ml = _member_lists(of[:, :n], n, gcap)
    pads_g = torch.full((S, gcap), n, dtype=_I64, device=dev)
    dump = torch.full((S,), n, dtype=_I64, device=dev)

    og_p = of.gather(1, rem_map.clamp(0, n - 1))
    remM = remM & (og_p[:, :, None] == og_p[:, None, :])
    rem_f, rem_live, cmax, per_lane = _true_indices(remM.reshape(S, -1),
                                                    stats, "adjust")
    _count(stats, "edges_removed", sum(per_lane))
    _count(stats, "iters_removed", cmax)
    for i in range(cmax):
        fi = rem_f[:, i]
        u = _col(rem_map, fi // h)
        v = _col(rem_map, fi % h)
        cu = _col(of, u)
        do = rem_live[:, i] & (cu == _col(of, v)) & (_col(gsize, cu) > 1)
        mem = ml[L, cu]                              # (S, gcap)
        gvalid = mem < n
        Wsub = _sub_weights(W, lut, mem)
        pu = (mem == u[:, None]).to(_F32).argmax(1)
        pv = (mem == v[:, None]).to(_F32).argmax(1)
        right_g = _split_sides(Wsub, gvalid, pu, pv, gcap) & do[:, None]
        nr = right_g.sum(1)
        of.scatter_(1, torch.where(right_g, mem, n),
                    ngroups[:, None].expand(S, gcap))
        g2 = gsize.clone()
        g2.scatter_add_(1, cu[:, None], -nr[:, None])
        g2.scatter_(1, ngroups[:, None], nr[:, None])
        gsize = torch.where(do[:, None], g2, gsize)
        lit = torch.sort(torch.where(gvalid & ~right_g, mem, n), 1).values
        rit = torch.sort(torch.where(right_g, mem, n), 1).values
        ml[L, torch.where(do, cu, dump)] = lit
        ml[L, torch.where(do, ngroups, dump)] = rit
        ngroups = ngroups + do.to(_I64)

    og_c = of.gather(1, hot_idx.clamp(0, n - 1))
    addM = addM & (og_c[:, :, None] != og_c[:, None, :])
    add_f, add_live, cmax, per_lane = _true_indices(addM.reshape(S, -1),
                                                    stats, "adjust")
    _count(stats, "edges_added", sum(per_lane))
    _count(stats, "iters_added", cmax)
    for i in range(cmax):
        fi = add_f[:, i]
        u = _col(hot_idx, fi // h)
        v = _col(hot_idx, fi % h)
        cu = _col(of, u)
        cv = _col(of, v)
        g = _col(gsize, cu) + _col(gsize, cv)
        mem = torch.cat([ml[L, cu], ml[L, cv]], 1)   # (S, 2 gcap)
        mh = lut.gather(1, mem)
        mhc = mh.clamp(min=0)
        okm = (mh >= 0)[:, :, None] & (mh >= 0)[:, None, :]
        ne = (_sub2(binary, mhc) & okm).sum((1, 2)) // 2
        do = (add_live[:, i] & (cu != cv) & (g <= omega)
              & (ne == g * (g - 1) // 2))
        keep = torch.minimum(cu, cv)
        drop = torch.maximum(cu, cv)
        of.scatter_(1, torch.where(do[:, None], mem, n),
                    keep[:, None].expand(S, 2 * gcap))
        g2 = gsize.clone()
        g2.scatter_(1, keep[:, None], g[:, None])
        g2.scatter_(1, drop[:, None], 0)
        gsize = torch.where(do[:, None], g2, gsize)
        merged = torch.sort(mem, 1).values[:, :gcap]
        ml[L, torch.where(do, keep, dump)] = merged
        ml[L, torch.where(do, drop, dump)] = pads_g

    of, gsize = of[:, :n], gsize[:, :n]
    alive = gsize > 0
    newid = torch.cumsum(alive.to(_I64), 1) - 1
    of = newid.gather(1, of)
    gs = torch.zeros((S, n + 1), dtype=_I64, device=dev)
    gs.scatter_add_(1, torch.where(alive, newid, n), gsize)
    return of, gs[:, :n]


def _split_oversized(of, gsize, W, lut, omega, stats, *, n, gcap):
    """``cgm._split_oversized`` in every lane, the LIFO worklist as a
    device stack a lane.

    Each lane's oversized slots go on its stack in reverse, so the lowest
    is popped first and its pieces (pushed on top) are done before the
    next slot, the unlaned order; an entry carries its slot, and the emit
    counter restarts when the popped slot changes.  One sync an iteration
    reads whether any lane pops, whether any splits, and whether this pop
    empties every stack.
    """
    S = of.shape[0]
    dev = of.device
    L = torch.arange(S, device=dev)
    KW = gcap + 1
    triu_g = torch.triu(torch.ones((gcap, gcap), dtype=torch.bool,
                                   device=dev), diagonal=1)
    os_idx, os_live, nos, _ = _true_indices(gsize > omega[:, None], stats,
                                            "split")
    of_key = torch.cat([of * KW, of.new_zeros((S, 1))], 1)
    if nos == 0:
        return _dense_rank(of_key[:, :n])
    ml = _member_lists(of, n, gcap)
    cap = nos + gcap + 1                             # + a dump entry
    cnt = os_live.sum(1)
    k = torch.arange(nos, device=dev)
    os_rev = os_idx.gather(1, (cnt[:, None] - 1 - k[None, :]).clamp(min=0))
    stack = torch.full((S, cap + 1, gcap), n, dtype=_I64, device=dev)
    stack[:, :nos] = torch.where(os_live[:, :, None],
                                 ml[L[:, None], os_rev], n)
    slot_st = torch.zeros((S, cap + 1), dtype=_I64, device=dev)
    slot_st[:, :nos] = os_rev
    sp = cnt.clone()
    emit = torch.zeros(S, dtype=_I64, device=dev)
    last = torch.full((S,), -1, dtype=_I64, device=dev)
    dump = torch.full((S,), cap, dtype=_I64, device=dev)
    while True:
        running = sp > 0
        top = (sp - 1).clamp(min=0)
        g = stack[L, top]                            # (S, gcap)
        sl = slot_st[L, top]
        gvalid = g < n
        small = gvalid.sum(1) <= omega
        split = running & ~small
        pops, n_split, last_pop = _sync_all(stats, "split", torch.stack([
            running.sum(), split.sum(),
            ((~split).all() & (sp <= 1).all()).to(_I64)]))
        if not pops:
            break
        _count(stats, "split_iters")
        _count(stats, "split_pops", pops)
        emit_l = running & small
        emit = torch.where(running & (sl != last), 0, emit)
        last = torch.where(running, sl, last)
        of_key.scatter_(1, torch.where(emit_l[:, None], g, n),
                        (sl * KW + emit)[:, None].expand(S, gcap))
        emit = emit + emit_l.to(_I64)
        sp = sp - running.to(_I64)
        if n_split:
            Wsub = _sub_weights(W, lut, g)
            pairm = gvalid[:, :, None] & gvalid[:, None, :] & triu_g
            P = torch.where(pairm, Wsub, float("inf"))
            f = P.reshape(S, -1).argmin(1)
            right = _split_sides(Wsub, gvalid, f // gcap, f % gcap, gcap)
            rit = torch.sort(torch.where(right, g, n), 1).values
            lit = torch.sort(torch.where(gvalid & ~right, g, n), 1).values
            pr = torch.where(split, sp, dump)
            pl = torch.where(split, sp + 1, dump)
            stack[L, pr] = rit
            stack[L, pl] = lit
            slot_st[L, pr] = sl
            slot_st[L, pl] = sl
            sp = sp + 2 * split.to(_I64)
        if last_pop:
            break
    return _dense_rank(of_key[:, :n])


def _bincount(idx, n):
    """Per lane, counts of ``idx`` (S, k) values in [0, n]: (S, n+1)."""
    out = torch.zeros((idx.shape[0], n + 1), dtype=_I64, device=idx.device)
    return out.scatter_add_(1, idx, torch.ones_like(idx))


def _approx_merge(of, binary, hot_idx, valid_h, cs, stats, *, n, h,
                  use_kernels, full_merge):
    """``cgm._approx_merge`` in every lane: one laned
    ``clique_pair_edges`` and ``merge_density`` for the starting X and D,
    then the merge loop for the largest lane's count of merges.  A lane
    that stopped (no density at or above gamma) stays stopped, so a lane
    still merging at iteration k has merged k times: the loop ends on the
    host once the largest act count less k is below 2."""
    if h * (h - 1) // 2 >= _F32_EXACT:
        raise ValueError(
            f"device CGM hot capacity h={h} puts the pairwise edge "
            "count h*(h-1)/2 at/above 2**24")
    S = of.shape[0]
    dev = of.device
    L = torch.arange(S, device=dev)
    omega, gamma32 = cs["omega"], cs["gamma32"]
    scap = 2 * n if full_merge else 2 * h
    slot = torch.arange(scap, dtype=_I64, device=dev)
    hot_of = of.gather(1, hot_idx.clamp(0, n - 1))
    sizes_n = _bincount(of, n)[:, :n]
    alive_n = sizes_n > 0
    prune = cs["prune"][:, None]
    has_hot = _bincount(torch.where(valid_h, hot_of, n), n)[:, :n] > 0
    live_h = valid_h & binary.any(dim=2)
    has_live = _bincount(torch.where(live_h, hot_of, n), n)[:, :n] > 0
    is_rest = alive_n & ~has_hot & prune
    act_n = alive_n & (has_live | ~prune) & ~is_rest

    msl_n = torch.cumsum(act_n.to(_I64), 1) - 1
    n0 = act_n.sum(1)
    n_act0 = [int(k) for k in _sync_all(stats, "merge", n0)]
    slot_of_m = _compact_rows(act_n, scap)
    of2 = torch.where(act_n.gather(1, of), msl_n.gather(1, of), scap + of)
    sizes_pad = torch.cat([sizes_n, sizes_n.new_zeros((S, 1))], 1)
    sizes = sizes_pad.gather(1, slot_of_m.clamp(0, n)).to(torch.int32)
    alive = slot[None, :] < n0[:, None]
    act = alive.clone()

    hs = torch.where(valid_h & act_n.gather(1, hot_of),
                     msl_n.gather(1, hot_of), scap)
    hs = torch.where(hs <= scap, hs, scap)
    A = binary.to(_F32)
    M = torch.zeros((S, scap, h), dtype=_F32, device=dev)
    M[L[:, None], hs.clamp(max=scap - 1),
      torch.arange(h, device=dev)[None, :]] = (hs < scap).to(_F32)
    big = max(n_act0, default=0)
    capture.keep_largest("clique_pair_edges_lanes", big,
                         lambda: (M.clone(), A.clone()))
    om32 = cs["omega32"]
    if use_kernels:
        X = clique_pair_edges(M, A)
        capture.keep_largest(
            "merge_density_lanes", big,
            lambda: (X.clone(), sizes.clone(), om32, gamma32, n0, big))
        D = merge_density(X, sizes, om32, gamma32, n_act=n0, act_max=big)
    else:
        X = clique_pair_edges_plain(M, A)
        D = merge_density_lanes_plain(X, sizes, om32, gamma32, n0)
    omf = cs["omega_f"]
    e_max = (omf * (omf - 1.0) / 2.0).to(_F32)[:, None]
    sizes = sizes.to(_I64)

    t = n0.clone()
    n_act = n0.clone()
    k = 0
    while big - k >= 2:
        Df = D.reshape(S, -1)
        f = Df.argmax(1)
        go = (n_act >= 2) & (_col(Df, f) >= 0.0)
        n_go = _sync_all(stats, "merge", go.sum())
        if not n_go:
            break
        k += 1
        _count(stats, "merges", n_go)
        _count(stats, "merge_iters")
        gc = go[:, None]
        a, b = f // scap, f % scap
        ai, aj = torch.minimum(a, b), torch.maximum(a, b)
        mm = ((of2 == ai[:, None]) | (of2 == aj[:, None])) & gc
        of2 = torch.where(mm, t[:, None], of2)
        xi, xj = X[L, ai], X[L, aj]                  # (S, scap)
        row = xi + xj
        dg = (_col(xi, ai) + _col(xj, aj)) + 2.0 * _col(xi, aj)
        X[L, t] = torch.where(gc, row, X[L, t])
        X[L, :, t] = torch.where(gc, row, X[L, :, t])
        X[L, t, t] = torch.where(go, dg, X[L, t, t])
        gnew = _col(sizes, ai) + _col(sizes, aj)
        sizes[L, t] = torch.where(go, gnew, sizes[L, t])
        for flags in (alive, act):
            flags[L, ai] &= ~go
            flags[L, aj] &= ~go
            flags[L, t] |= go
        # the new group's density row, the unlaned op order
        wt = dg / 2.0
        wl = torch.diagonal(X, dim1=1, dim2=2) / 2.0
        e_row = (wt[:, None] + wl) + X[L, t]
        okr = (gnew[:, None] + sizes) == omega[:, None]
        dr = torch.where(okr, e_row / e_max, -1.0)
        dr = torch.where(dr >= gamma32[:, None], dr, -1.0)
        validc = act & alive & (slot[None, :] != t[:, None])
        dr = torch.where(validc, dr, -2.0)
        for ix in (ai, aj):
            D[L, ix] = torch.where(gc, -2.0, D[L, ix])
            D[L, :, ix] = torch.where(gc, -2.0, D[L, :, ix])
        D[L, t] = torch.where(gc, dr, D[L, t])
        D[L, :, t] = torch.where(gc, dr, D[L, :, t])
        D[L, t, t] = torch.where(go, -2.0, D[L, t, t])
        t = t + go.to(_I64)
        n_act = n_act - go.to(_I64)

    key_m = torch.where(slot[None, :] < n0[:, None], slot_of_m,
                        n + slot[None, :])
    iota_n = torch.arange(n, dtype=_I64, device=dev)
    key_p = torch.where(is_rest, (n + scap) + iota_n, iota_n)
    keys = torch.cat([key_m, key_p], 1)
    return _dense_rank(keys.gather(1, of2))


def _install_partition(carry, of_new, now, dt, *, n, seed_new):
    """``cgm._install_partition_device`` in every lane."""
    E_old, a_old = carry["E"], carry["anchor"]
    of_old, cnt_old = carry["of"], carry["cnt"]
    S, _, m = E_old.shape
    dev = E_old.device
    cnt_new = torch.zeros((S, n + 1), dtype=_F64, device=dev)
    cnt_new.scatter_add_(1, of_new, torch.ones((S, n), dtype=_F64,
                                               device=dev))
    slot_valid = cnt_new > 0.0
    mn = torch.full((S, n + 1), _INT_MAX, dtype=_I64, device=dev)
    mn.scatter_reduce_(1, of_new, of_old, "amin", include_self=True)
    mx = torch.full((S, n + 1), _INT_MIN, dtype=_I64, device=dev)
    mx.scatter_reduce_(1, of_new, of_old, "amax", include_self=True)
    cand = mn.clamp(0, n)
    matched = slot_valid & (mn == mx) & (cnt_old.gather(1, cand) == cnt_new)
    item_E = E_old.gather(1, of_old[:, :, None].expand(S, n, m))
    min_E = torch.full((S, n + 1, m), float("inf"), dtype=_F64, device=dev)
    min_E.scatter_reduce_(1, of_new[:, :, None].expand(S, n, m), item_E,
                          "amin", include_self=True)
    fresh = torch.where(slot_valid[:, :, None] & (min_E > now), min_E, 0.0)
    row_max = fresh.max(dim=2).values
    anew = torch.where(row_max > 0.0, fresh.argmax(dim=2), -1)
    if seed_new:
        ssum = torch.zeros((S, n + 1, m), dtype=_I64, device=dev)
        ssum.scatter_add_(1, of_new[:, :, None].expand(S, n, m),
                          carry["seed"][:n].expand(S, n, m))
        js = ssum.argmax(dim=2)
        need = slot_valid & ~matched & (row_max <= 0.0) & (cnt_new > 1.0)
        col = torch.arange(m, device=dev)
        fresh = torch.where(need[:, :, None] & (col == js[:, :, None]),
                            (now + dt.gather(1, js))[:, :, None], fresh)
        anew = torch.where(need, js, anew)
    E_new = torch.where(matched[:, :, None],
                        E_old.gather(1, cand[:, :, None].expand(S, n + 1, m)),
                        fresh)
    a_new = torch.where(matched, a_old.gather(1, cand), anew)
    return E_new, a_new, cnt_new


def _cgm_boundary(carry, now, cs, dt, item_sizes, stats, *, n, m, h, wcap,
                  uses_sizes, enable_split, enable_acm, seed_new,
                  use_kernels, gcap, full_merge):
    """One T_CG boundary in every lane: Alg. 2 -> 4 -> 3 -> install."""
    hot_idx, valid_h, lut, raw, norm, binary = _window_crm(
        carry, cs, n=n, h=h, wcap=wcap, use_kernels=use_kernels)
    W = norm.to(_F64)
    S = W.shape[0]
    dev = W.device
    p_idx, pbin = carry["p_idx"], carry["pbin"]
    ci = _lut(p_idx, n, h).gather(1, hot_idx)        # cur slot -> prev slot
    pc = lut.gather(1, p_idx)                        # prev slot -> cur slot
    pcv, civ = pc >= 0, ci >= 0
    cur_in_prev = (_sub2(binary, pc.clamp(min=0))
                   & pcv[:, :, None] & pcv[:, None, :])
    prev_in_cur = (_sub2(pbin, ci.clamp(min=0))
                   & civ[:, :, None] & civ[:, None, :])
    triu_h = torch.triu(torch.ones((h, h), dtype=torch.bool, device=dev),
                        diagonal=1)
    remM = pbin & ~cur_in_prev & triu_h
    addM = binary & ~prev_in_cur & triu_h
    gsize = carry["cnt"][:, :n].to(_I64)
    of, gsize = _adjust_partition(
        carry["of"], gsize, binary, W, hot_idx, lut, addM, remM, p_idx,
        cs["omega"], stats, n=n, h=h, gcap=gcap)
    if enable_split:
        of = _split_oversized(of, gsize, W, lut, cs["omega"], stats, n=n,
                              gcap=gcap)
    if enable_acm:
        of = _approx_merge(of, binary, hot_idx, valid_h, cs, stats, n=n,
                           h=h, use_kernels=use_kernels,
                           full_merge=full_merge)
    E_new, a_new, cnt_new = _install_partition(
        carry, of, now, dt, n=n, seed_new=seed_new)
    out = dict(
        carry, E=E_new, anchor=a_new, of=of, cnt=cnt_new, wlen=0,
        wcnt=torch.zeros(n + 1, dtype=_I64, device=dev),
        seed=torch.zeros((n + 1, m), dtype=_I64, device=dev),
        p_idx=hot_idx, pbin=binary, praw=raw, pnorm=norm,
    )
    if uses_sizes:
        vol = torch.zeros((S, n + 1), dtype=_F64, device=dev)
        out["vol"] = vol.scatter_add_(1, of, item_sizes.expand(S, n))
    return out


# ---------------------------------------------------------------------------
# the Alg. 5/6 cost step, laned
# ---------------------------------------------------------------------------
def _first_last(sk):
    S = sk.shape[0]
    diff = sk[:, 1:] != sk[:, :-1]
    one = torch.ones((S, 1), dtype=torch.bool, device=sk.device)
    return torch.cat([one, diff], 1), torch.cat([diff, one], 1)


def _event_step(carry, x, spec, *, kind, charge, uses_sizes, item_sizes,
                dt_e, n, m):
    """``cgm._event_step`` in every lane: the requests are shared, each
    lane's events follow its own slot map; the sorts run along the event
    axis of each lane.  ``E`` and ``anchor`` are updated in place."""
    E, anchor = carry["E"], carry["anchor"]
    of, cnt = carry["of"], carry["cnt"]
    S = E.shape[0]
    dev = E.device
    K = n
    Lc = torch.arange(S, device=dev)[:, None]
    items = x["items"]
    B, d = items.shape
    NE = B * d
    valid = (items >= 0).reshape(NE)
    item = items.clamp(0, n - 1).reshape(NE)
    r = torch.arange(B, dtype=_I64, device=dev)[:, None].expand(B, d)
    r = r.reshape(NE)
    cl = torch.where(valid[None, :], of[:, item], K)
    key = r[None, :] * (K + 1) + cl
    o = torch.argsort(key, dim=1, stable=True)
    sk = key.gather(1, o)
    first, _ = _first_last(sk)
    seg = torch.cumsum(first.to(_I64), 1) - 1
    vmask = valid[o]
    n_req = torch.zeros((S, NE), dtype=_F64, device=dev).scatter_add_(
        1, seg, vmask.to(_F64))
    pad_key = (B - 1) * (K + 1) + K
    dst = torch.where(first, seg, NE)
    ev_key = torch.full((S, NE + 1), pad_key, dtype=_I64, device=dev)
    ev_key.scatter_(1, dst, sk)
    ev_key = ev_key[:, :NE]
    ev_r = ev_key // (K + 1)
    ev_c = ev_key % (K + 1)
    j = x["servers"][ev_r]
    t = x["times"][ev_r]
    val = ev_c < K
    size = cnt.gather(1, ev_c)
    if uses_sizes:
        isz = torch.where(vmask, item_sizes[item][o], 0.0)
        req_size = torch.zeros((S, NE), dtype=_F64, device=dev).scatter_add_(
            1, seg, isz)
        csize = carry["vol"].gather(1, ev_c)
    else:
        csize = size
        req_size = n_req

    key_cj = ev_c * m + j
    o_cj = torch.argsort(key_cj, dim=1, stable=True)
    kcs = key_cj.gather(1, o_cj)
    first_cj_s, last_cj_s = _first_last(kcs)
    t_cj_s = t.gather(1, o_cj)
    prev_t_s = torch.where(
        first_cj_s, 0.0, torch.cat([t_cj_s.new_zeros((S, 1)), t_cj_s[:, :-1]],
                                   1))
    first_cj = torch.empty_like(first_cj_s).scatter_(1, o_cj, first_cj_s)
    prev_cj_t = torch.empty_like(prev_t_s).scatter_(1, o_cj, prev_t_s)

    o_c = torch.argsort(ev_c, dim=1, stable=True)
    cs = ev_c.gather(1, o_c)
    first_c_s, last_c_s = _first_last(cs)
    j_c_s = j.gather(1, o_c)
    prev_j_s = torch.where(
        first_c_s, -1, torch.cat([j_c_s.new_full((S, 1), -1), j_c_s[:, :-1]],
                                 1))
    first_c = torch.empty_like(first_c_s).scatter_(1, o_c, first_c_s)
    prev_j = torch.empty_like(prev_j_s).scatter_(1, o_c, prev_j_s)

    E_before = torch.where(first_cj, E[Lc, ev_c, j], prev_cj_t + dt_e)
    a0 = anchor.gather(1, ev_c)
    anchor_alive = torch.where(
        first_c, (a0 == j) & (E_before > 0.0), prev_j == j)
    fresh = E_before > t
    alive = fresh | anchor_alive
    miss = ~alive & val
    lapsed = alive & ~fresh & val
    steps = torch.ceil((t - E_before) / dt_e)
    rr = E_before + steps * dt_e
    rr = torch.where(rr <= t, rr + dt_e, rr)
    e_eff = torch.where(fresh, E_before, torch.where(lapsed, rr, t))
    rate_stored = _rate_hook(kind, spec, size, csize, j)
    rent = torch.where(lapsed, rate_stored * (e_eff - E_before), 0.0)
    tc = torch.where(miss, _transfer_hook(kind, spec, size, csize, j), 0.0)
    if charge == "requested":
        rate = _rate_hook(kind, spec, n_req, req_size, j)
    else:
        rate = rate_stored
    dur = torch.clamp((t + dt_e) - torch.maximum(e_eff, t), min=0.0)
    cc = torch.where(val, rate * dur, 0.0)
    nm = miss.sum(1)
    carry["acc"] += torch.stack([
        tc.sum(1), cc.sum(1), rent.sum(1),
        nm.to(_F64), (val.sum(1) - nm).to(_F64),
        torch.where(miss, size, 0.0).sum(1),
    ], 1)

    uc = torch.where(last_cj_s, kcs // m, K)
    uj = torch.where(last_cj_s, kcs % m, 0)
    E[Lc, uc, uj] = t_cj_s + dt_e
    ac = torch.where(last_c_s, cs, K)
    a_cur = anchor.gather(1, ac)
    aE = E[Lc, ac, a_cur.clamp(min=0)]               # POST-update E
    t_c_s = t.gather(1, o_c)
    upd = (a_cur < 0) | (t_c_s + dt_e >= aE)
    anchor[Lc, torch.where(upd, ac, K)] = j_c_s
    return carry


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
def run_cgm_lanes(schedule, spec, statics, cspec, carry0, item_sizes, *,
                  charge="requested", enable_split=True, enable_acm=True,
                  seed_new=True, use_kernels=True):
    """Execute one CGM schedule for S lanes on the carry's device.

    ``spec`` and ``cspec`` hold (S, ...) numpy arrays (the lanes' pricing
    specs and :func:`stack_cspecs` knobs), ``carry0`` is a laned carry
    (:func:`init_lane_carry`).  Returns ``(final_carry, boundary_ofs,
    stats)``: the laned carry after the last step, the slot maps (S,
    boundaries, n) on the device, and the run's record: lanes, the loop
    capacities ``gcap`` and ``full_merge``, host syncs by kind
    (``sync_*``), iterations by loop (``iters_removed``,
    ``iters_added``, ``split_iters``, ``merge_iters``), and the edges,
    pops and merges summed over the lanes.
    """
    dev = carry0["E"].device
    n, m = schedule.n, schedule.m
    h = carry0["p_idx"].shape[1]
    wcap = carry0["wbuf"].shape[0]
    S = carry0["E"].shape[0]
    gcap, full_merge = lane_loop_statics(cspec, carry0, enable_acm=enable_acm)
    cs = cspec_to_device(cspec, dev)
    spec_d = lane_spec_to_device(spec, dev, laned=True)
    dt = spec_d["dt"]
    # dt[:, 0] as a device tensor: a divisor never a host scalar
    dt_e = dt[:, :1]
    uses_sizes = "vol" in carry0
    sz = item_sizes
    if sz is not None and not isinstance(sz, torch.Tensor):
        sz = torch.as_tensor(np.asarray(sz, np.float64), device=dev)
    xs = schedule.xs
    items = torch.as_tensor(xs["items"].astype(np.int64), device=dev)
    servers = torch.as_tensor(xs["servers"].astype(np.int64), device=dev)
    times = torch.as_tensor(xs["times"], dtype=_F64, device=dev)
    stats: dict = {"lanes": S, "gcap": gcap, "full_merge": full_merge}
    carry = dict(carry0)
    ofs = []
    for b in range(schedule.nb):
        nreq = int(xs["nreq"][b])
        if xs["cg"][b]:
            carry = _cgm_boundary(
                carry, float(xs["now"][b]), cs, dt, sz, stats, n=n, m=m,
                h=h, wcap=wcap, uses_sizes=uses_sizes,
                enable_split=enable_split, enable_acm=enable_acm,
                seed_new=seed_new, use_kernels=use_kernels, gcap=gcap,
                full_merge=full_merge)
            ofs.append(carry["of"])
        if nreq == 0:
            continue
        x = {"items": items[b], "servers": servers[b], "times": times[b],
             "nreq": nreq}
        carry = _accumulate_window(carry, x, n=n)
        carry = _event_step(
            carry, x, spec_d, kind=statics, charge=charge,
            uses_sizes=uses_sizes, item_sizes=sz, dt_e=dt_e, n=n, m=m)
    ofs = (torch.stack(ofs, 1) if ofs
           else torch.zeros((S, 0, n), dtype=_I64, device=dev))
    return carry, ofs, stats
