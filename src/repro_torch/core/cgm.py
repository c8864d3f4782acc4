"""Device clique generation inside the replay: the CGM on the card.

The device half of ``repro.core.cgm_jax``.  The replay walks the host-built
:class:`~repro_torch.core.cgm_schedule.CGMSchedule` step by step; a step
that begins a new T_CG period first runs the boundary, entirely on the
device:

* Alg. 2 — hot set (stable rank of window counts), the ``(h, h)`` CRM as
  ``H^T H`` over the buffered window (kernel ``crm_update``), min-max
  normalise, binarise at theta;
* Alg. 4 — the edge diff against the previous window's binary CRM, then
  the removed-edge splits and added-edge merges, one edge at a time over
  fixed-capacity member lists;
* Alg. 3 — oversized-clique splits as a LIFO worklist, and the
  approximate merge as a loop over the thresholded density matrix in an
  ``(S, S)`` act-compacted slot space, ``S = 2h`` (kernels
  ``clique_pair_edges`` for ``X = M A M^T`` and ``merge_density`` for the
  initial density matrix);
* the partition install as segment reductions over the old slot map.

Then every step folds its requests into the window buffers and runs the
Alg. 5/6 cost step on deduplicated (request, clique) events built on the
device.

From JAX to PyTorch: ``lax.scan`` is a Python loop over steps, and
``lax.cond`` on the host-known boundary flag a plain ``if``.  The bounded
``fori_loop``s over edges, oversized groups and group members are Python
loops; their trip counts come from one ``nonzero`` each (one device sync).
The data-dependent ``while_loop``s (split worklist, merge loop) read their
predicate with one sync per iteration; ``stats`` counts every sync and
every loop trip.  The
state ``E`` and ``anchor`` are updated in place (the reference's
``0.0 * dep`` trick only forced XLA to do so).  Out-of-range scatters of
the reference (JAX drops them) go to explicit dump slots here; every
scatter whose indices repeat writes one value, or repeats only on a dump
slot; every sort and argsort is stable; every argmax/argmin takes the
first index.  Indices are int64 throughout.

Parity bar, as the reference's: partitions element for element equal to
the frozen ``cliques_ref`` oracle at every boundary, ``E``/anchor float for
float equal to the numpy engine, costs at 1e-9.  The f32 CRM / X counts
are exact integers below 2**24, guarded below.

Contraction forms: the reference chooses among the kernel, a dense
one-hot and a pair-scatter form of the CRM and of ``X`` (the latter two
tuned for XLA on the CPU).  The port keeps the kernel form only; with
``use_kernels=False`` the same form runs through the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.clique_density import clique_pair_edges, clique_pair_edges_plain
from ..kernels.crm_update import crm_update, crm_update_plain
from ..kernels.merge_step import merge_density, merge_density_plain
from .cgm_schedule import (
    _F32_EXACT,
    build_cgm_schedule,
    cgm_spec,
    partition_from_of,
    policy_hot_dims,
    sync_policy_from_run,
)
from .engine import CacheState
from .replay import (
    N_ACC,
    _bucket,
    _rate_hook,
    _transfer_hook,
    apply_acc,
    spec_to_device,
    state_to_device,
)

_I64 = torch.int64
_INT_MAX = torch.iinfo(torch.int64).max
_INT_MIN = torch.iinfo(torch.int64).min


#: named spans for ``torch.profiler`` traces (cheap when no profiler runs)
_span = torch.profiler.record_function


def _count(stats: dict, key: str, k: int = 1) -> None:
    stats[key] = stats.get(key, 0) + k


def _sync(stats: dict, kind: str, t: torch.Tensor):
    """Read a device value on the host, counting the sync."""
    _count(stats, "sync_" + kind)
    return t.item()


# ---------------------------------------------------------------------------
# window accumulation (Alg. 2 running state)
# ---------------------------------------------------------------------------
def _accumulate_window(carry, x, *, n):
    """Fold one request batch into the open window's buffers.

    * ``wbuf`` (wcap, dbuf) — the window's raw request rows; the whole
      padded block lands at row ``wlen`` and ``wlen`` (a host int)
      advances by the step's VALID row count, so pad rows are overwritten
      by the next step.
    * ``wcnt`` (n+1,) — per-item access counts WITH duplicates.
    * ``seed`` (n+1, m) — (item, server) counts WITH duplicates.
    Invalid slots count on the dump item ``n``.
    """
    items = x["items"]                               # (B, d)
    B, d = items.shape
    wlen = carry["wlen"]
    carry["wbuf"][wlen:wlen + B].fill_(-1)
    carry["wbuf"][wlen:wlen + B, :d] = items
    valid = items >= 0
    col = torch.where(valid, items, n)
    carry["wcnt"].index_add_(
        0, col.reshape(-1), torch.ones(B * d, dtype=_I64, device=items.device))
    srv = x["servers"][:, None].expand(B, d)
    carry["seed"].index_put_((col, srv), valid.to(_I64), accumulate=True)
    carry["wlen"] = wlen + x["nreq"]
    return carry


# ---------------------------------------------------------------------------
# compact-space primitives
# ---------------------------------------------------------------------------
def _compact_indices(mask, size):
    """Ascending indices of True entries, padded with ``len(mask)``;
    entries past ``size`` collapse onto the dropped dump slot."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(_I64), 0) - 1
    idx = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), n, dtype=_I64, device=mask.device)
    out.scatter_(0, idx, torch.arange(n, dtype=_I64, device=mask.device))
    return out[:size]


def _member_lists(of, n, gcap):
    """(n+1, gcap) member lists of every group: ascending ids, pads = n.

    One stable argsort + rank-in-run scatter builds all lists.  Members
    past ``gcap`` (which the ``_split_oversized`` invariant rules out) go
    to a dropped dump column.
    """
    dev = of.device
    order = torch.argsort(of, stable=True)
    og = of[order]
    iota = torch.arange(n, dtype=_I64, device=dev)
    newrun = torch.ones(n, dtype=torch.bool, device=dev)
    newrun[1:] = og[1:] != og[:-1]
    start = torch.cummax(torch.where(newrun, iota, 0), 0).values
    col = iota - start
    col = torch.where(col < gcap, col, gcap)
    ml = torch.full((n + 1, gcap + 1), n, dtype=_I64, device=dev)
    ml[og, col] = order
    return ml[:, :gcap].contiguous()


def _dense_rank(keys):
    """Dense rank (0..k-1) of each entry by ascending key value."""
    sk = torch.sort(keys, stable=True).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    rnk = torch.cumsum(first.to(_I64), 0) - 1
    return rnk[torch.searchsorted(sk, keys)]


def _take(v, i):
    """``v[i]`` for a 1-element index tensor, without a host sync."""
    return v.index_select(0, i)


def _split_sides_compact(W, member, u, v, cap):
    """``split_clique_on_edge`` over a compact member mask: True = right.

    ``W`` is a (cap, cap) float64 weight matrix; ``u`` / ``v`` are
    1-element compact indices (-1 for a cold endpoint).  The side-weight
    accumulators update in ascending compact order, and a tie
    ``wl[p] >= wr[p]`` sends p left — the host's order exactly.
    """
    dev = W.device
    zero = torch.zeros(cap, dtype=W.dtype, device=dev)
    wl = torch.where(u >= 0, W.index_select(1, u.clamp(min=0))[:, 0], zero)
    wr = torch.where(v >= 0, W.index_select(1, v.clamp(min=0))[:, 0], zero)
    right = torch.arange(cap, device=dev) == v
    for p in range(cap):
        act = member[p:p + 1] & (u != p) & (v != p)
        go_left = wl[p:p + 1] >= wr[p:p + 1]
        right[p:p + 1] = right[p:p + 1] | (act & ~go_left)
        colp = W[:, p]
        wl = torch.where(act & go_left, wl + colp, wl)
        wr = torch.where(act & ~go_left, wr + colp, wr)
    return right & member


def _sub_weights(W, lut, mem):
    """(g, g) weights of members ``mem`` (ids, pads = n); cold/pad = 0."""
    gh = lut[mem]
    ghc = gh.clamp(min=0)
    okw = (gh >= 0)[:, None] & (gh >= 0)[None, :]
    return torch.where(okw, W[ghc][:, ghc], 0.0)


# ---------------------------------------------------------------------------
# Alg. 2 at a boundary
# ---------------------------------------------------------------------------
def _window_crm_device(carry, cspec, *, n, h, wcap, use_kernels):
    """Hot set -> compact CRM -> binarise.

    Returns ``(hot_idx, valid_h, lut, raw, norm, binary)``: the ascending
    hot->catalog index map (pads = n), its validity mask, the
    catalog->hot lut (cold/pad -> -1) and the (h, h) raw/norm/binary CRM.
    """
    if wcap >= _F32_EXACT:
        raise ValueError(
            f"device CGM window capacity wcap={wcap} reaches the f32 "
            "exact-integer bound 2**24; co-occurrence counts could "
            "silently lose exactness — lower the clique-generation period "
            "t_cg")
    dev = carry["wcnt"].device
    counts = carry["wcnt"][:n]
    if cspec["of_catalog"]:
        base = torch.tensor(float(n), dtype=torch.float64, device=dev)
    else:
        base = (counts > 0).sum().to(torch.float64)
    # host: max(1, int(round(base * top_frac))) — round half to even
    n_hot = torch.round(base * float(cspec["top_frac"])).clamp(min=1).to(_I64)
    order = torch.argsort(-counts, stable=True)      # ties -> low id
    rank = torch.empty(n, dtype=_I64, device=dev)
    rank[order] = torch.arange(n, dtype=_I64, device=dev)
    hot = (rank < n_hot) & (counts > 0)
    hot_idx = _compact_indices(hot, h)
    valid_h = hot_idx < n
    lut = torch.full((n + 1,), -1, dtype=_I64, device=dev)
    lut[hot_idx] = torch.arange(h, dtype=_I64, device=dev)
    lut[n] = -1

    wbuf = carry["wbuf"]                             # (wcap, dbuf)
    dbuf = wbuf.shape[1]
    rowi = torch.arange(wcap, dtype=_I64, device=dev)[:, None].expand(
        wcap, dbuf)
    live = (rowi < carry["wlen"]) & (wbuf >= 0)
    hs = lut[torch.where(live, wbuf, n)]             # hot slot or -1
    hcol = torch.where(hs >= 0, hs, h)               # cold/stale -> dump col
    H = torch.zeros((wcap, h + 1), dtype=torch.float32, device=dev)
    H[rowi, hcol] = 1.0
    raw = (crm_update if use_kernels else crm_update_plain)(H[:, :h])
    hi = raw.max().to(torch.float64)
    # host minmax_normalise: lo is always 0 (zero diagonal), hi<=0 -> 0;
    # f64 true-divide then cast f32
    norm = torch.where(hi > 0.0, (raw.to(torch.float64) / hi).to(torch.float32),
                       0.0)
    eye = torch.eye(h, dtype=torch.bool, device=dev)
    hm2 = valid_h[:, None] & valid_h[None, :]
    binary = (norm > float(cspec["theta"])) & hm2 & ~eye
    return hot_idx, valid_h, lut, raw, norm, binary


# ---------------------------------------------------------------------------
# Alg. 4 adjust + Alg. 3 split/merge in the compact hot space
# ---------------------------------------------------------------------------
def _adjust_partition(of, gsize, binary, W, hot_idx, lut, addM, remM,
                      rem_map, cspec, stats, *, n, h, gcap):
    """Alg. 4 (``adjust_previous_cliques``) over slot buffers.

    Removed-edge splits keep the left side in the parent slot and append
    the right side at ``ngroups``; added-edge merges keep ``min(cu, cv)``
    and kill the other.  Edges that cannot change anything are filtered
    first (during removals groups only split, during additions they only
    merge), keeping the survivors' lexicographic order.  The final
    compaction ranks alive slots ascending.  ``of`` and ``gsize`` carry a
    dump slot ``n`` inside the loops.
    """
    dev = of.device
    omega = int(cspec["omega"])
    of = torch.cat([of, of.new_zeros(1)])            # (n+1,), dump slot n
    gsize = torch.cat([gsize, gsize.new_zeros(1)])
    ngroups = (gsize[:n] > 0).sum().reshape(1)
    ml = _member_lists(of[:n], n, gcap)
    pads_g = torch.full((gcap,), n, dtype=_I64, device=dev)

    og_p = of[rem_map.clamp(0, n - 1)]               # group per prev slot
    remM = remM & (og_p[:, None] == og_p[None, :])
    rem_f = torch.nonzero(remM.reshape(-1)).reshape(-1)
    _count(stats, "sync_adjust")
    _count(stats, "edges_removed", rem_f.shape[0])
    for i in range(rem_f.shape[0]):
        fi = rem_f[i:i + 1]
        u = _take(rem_map, fi // h)
        v = _take(rem_map, fi % h)
        cu = _take(of, u)
        do = (cu == _take(of, v)) & (_take(gsize, cu) > 1)
        mem = ml[cu][0]                              # (gcap,) ascending ids
        gvalid = mem < n
        Wsub = _sub_weights(W, lut, mem)
        pu = (mem == u).to(torch.float32).argmax().reshape(1)
        pv = (mem == v).to(torch.float32).argmax().reshape(1)
        right_g = _split_sides_compact(Wsub, gvalid, pu, pv, gcap) & do
        nr = right_g.sum().reshape(1)
        of.index_put_((torch.where(right_g, mem, n),), ngroups.expand(gcap))
        g2 = gsize.clone()
        g2.index_add_(0, cu, -nr)
        g2.index_copy_(0, ngroups, nr)
        gsize = torch.where(do, g2, gsize)
        lit = torch.sort(torch.where(gvalid & ~right_g, mem, n)).values
        rit = torch.sort(torch.where(right_g, mem, n)).values
        ml.index_copy_(0, torch.where(do, cu, n), lit[None])
        ml.index_copy_(0, torch.where(do, ngroups, n), rit[None])
        ngroups = ngroups + do.to(_I64)

    og_c = of[hot_idx.clamp(0, n - 1)]               # group per cur slot
    addM = addM & (og_c[:, None] != og_c[None, :])
    add_f = torch.nonzero(addM.reshape(-1)).reshape(-1)
    _count(stats, "sync_adjust")
    _count(stats, "edges_added", add_f.shape[0])
    for i in range(add_f.shape[0]):
        fi = add_f[i:i + 1]
        u = _take(hot_idx, fi // h)
        v = _take(hot_idx, fi % h)
        cu = _take(of, u)
        cv = _take(of, v)
        g = _take(gsize, cu) + _take(gsize, cv)
        # fully connected: the union's in-edge count must be C(g, 2),
        # probed over the union's member lists; cold members have no edges
        mem = torch.cat([ml[cu][0], ml[cv][0]])      # (2 gcap,)
        mh = lut[mem]
        mhc = mh.clamp(min=0)
        okm = (mh >= 0)[:, None] & (mh >= 0)[None, :]
        ne = (binary[mhc][:, mhc] & okm).sum() // 2
        do = (cu != cv) & (g <= omega) & (ne == g * (g - 1) // 2)
        keep = torch.minimum(cu, cv)
        drop = torch.maximum(cu, cv)
        of.index_put_((torch.where(do, mem, n),), keep.expand(2 * gcap))
        g2 = gsize.clone()
        g2.index_copy_(0, keep, g)
        g2.index_fill_(0, drop, 0)
        gsize = torch.where(do, g2, gsize)
        ml.index_copy_(0, torch.where(do, keep, n),
                       torch.sort(mem).values[:gcap][None])
        ml.index_copy_(0, torch.where(do, drop, n), pads_g[None])

    of, gsize = of[:n], gsize[:n]
    alive = gsize > 0
    newid = torch.cumsum(alive.to(_I64), 0) - 1
    of = newid[of]
    gs = torch.zeros(n + 1, dtype=_I64, device=dev)
    gs.index_add_(0, torch.where(alive, newid, n), gsize)
    return of, gs[:n]


def _split_oversized(of, gsize, W, lut, cspec, stats, *, n, gcap):
    """Alg. 3 splits (``split_oversized``) as a LIFO worklist.

    Only oversized slots run the worklist; every other slot keeps its
    pass-through key.  Pieces keep the host's in-place order via the key
    ``slot * (gcap+1) + emit_idx``; the weakest edge is the first
    row-major minimum over member pairs (ascending ids: the host's scan
    order).  The worklist's top decides on the host whether it is small
    enough to emit (one sync per pop).
    """
    dev = of.device
    omega = int(cspec["omega"])
    KW = gcap + 1
    triu_g = torch.triu(torch.ones((gcap, gcap), dtype=torch.bool,
                                   device=dev), diagonal=1)
    os_idx = torch.nonzero(gsize > omega).reshape(-1)
    _count(stats, "sync_split")
    ml = _member_lists(of, n, gcap)
    of_key = torch.cat([of * KW, of.new_zeros(1)])   # (n+1,): dump slot n
    for i in range(os_idx.shape[0]):
        s = os_idx[i:i + 1]
        stack = [ml[s][0]]
        emit = 0
        while stack:
            g = stack.pop()                          # (gcap,) ascending ids
            _count(stats, "split_pops")
            gvalid = g < n
            if _sync(stats, "split", gvalid.sum() <= omega):
                of_key.index_put_((g,), (s * KW + emit).expand(gcap))
                emit += 1
                continue
            Wsub = _sub_weights(W, lut, g)
            pairm = gvalid[:, None] & gvalid[None, :] & triu_g
            P = torch.where(pairm, Wsub, float("inf"))
            f = P.reshape(-1).argmin().reshape(1)
            right = _split_sides_compact(Wsub, gvalid, f // gcap, f % gcap,
                                         gcap)
            stack.append(torch.sort(torch.where(right, g, n)).values)
            stack.append(torch.sort(torch.where(gvalid & ~right, g, n)).values)
    return _dense_rank(of_key[:n])


def _approx_merge(of, binary, hot_idx, valid_h, cspec, stats, *, n, h,
                  use_kernels, full_merge):
    """Alg. 3 approximate merge (``approximate_merge``) as a loop.

    The merge works in an act-compacted slot space of capacity ``scap``:
    act groups take slots 0..n_act-1 in input order, merged groups take
    tail slots, so the row-major first argmax over D breaks ties as the
    host does.  D uses the sentinel -2.0 for dead / non-act / diagonal
    entries; X is patched one row/col per merge with the host's f32 add
    order.  The loop predicate ``max D >= 0`` costs one sync per
    iteration.
    """
    if h * (h - 1) // 2 >= _F32_EXACT:
        raise ValueError(
            f"device CGM hot capacity h={h} puts the pairwise edge "
            f"count h*(h-1)/2 at/above 2**24; the f32 X counters would "
            "lose exactness")
    dev = of.device
    omega = int(cspec["omega"])
    omega_f = float(cspec["omega_f"])
    gamma32 = float(cspec["gamma32"])
    scap = 2 * n if full_merge else 2 * h
    slot = torch.arange(scap, dtype=_I64, device=dev)
    hot_of = of[hot_idx.clamp(0, n - 1)]             # group per hot slot
    sizes_n = torch.bincount(of, minlength=n)[:n]
    alive_n = sizes_n > 0
    # the hot filter only engages above the density bar
    prune = omega > 2 and float(cspec["gamma"]) > (omega_f - 2.0) / omega_f
    has_hot = torch.bincount(torch.where(valid_h, hot_of, n),
                             minlength=n + 1)[:n] > 0
    live_h = valid_h & binary.any(dim=1)
    has_live = torch.bincount(torch.where(live_h, hot_of, n),
                              minlength=n + 1)[:n] > 0
    is_rest = alive_n & ~has_hot if prune else torch.zeros_like(alive_n)
    act_n = alive_n & (has_live if prune else True) & ~is_rest

    msl_n = torch.cumsum(act_n.to(_I64), 0) - 1
    n_act0 = int(_sync(stats, "merge", act_n.sum()))
    slot_of_m = _compact_indices(act_n, scap)
    of2 = torch.where(act_n[of], msl_n[of], scap + of)
    sizes_pad = torch.cat([sizes_n, sizes_n.new_zeros(1)])
    sizes = sizes_pad[slot_of_m.clamp(0, n)].to(torch.int32)
    alive = slot < n_act0
    act = alive.clone()

    # X = M A M^T over hot membership (M: merge slots x hot slots, with a
    # dump row scap for cold/non-act hot slots)
    hs = torch.where(valid_h & act_n[hot_of], msl_n[hot_of], scap)
    hs = torch.where(hs <= scap, hs, scap)
    A = binary.to(torch.float32)
    M = torch.zeros((scap + 1, h), dtype=torch.float32, device=dev)
    M[hs, torch.arange(h, device=dev)] = 1.0
    M = M[:scap]
    if use_kernels:
        X = clique_pair_edges(M, A)
        D = merge_density(X, sizes, omega, gamma32)
    else:
        X = clique_pair_edges_plain(M, A)
        D = merge_density_plain(X, sizes, omega, gamma32)
    e_max = torch.tensor(omega_f * (omega_f - 1.0) / 2.0, dtype=torch.float64,
                         device=dev).to(torch.float32)
    eyeS = torch.eye(scap, dtype=torch.bool, device=dev)
    actp = act[:, None] & act[None, :] & ~eyeS
    D = torch.where(actp, D, -2.0)
    sizes = sizes.to(_I64)

    t = n_act0
    n_act = n_act0
    while n_act >= 2:
        Df = D.reshape(-1)
        f = Df.argmax().reshape(1)
        if not _sync(stats, "merge", _take(Df, f)[0] >= 0.0):
            break
        _count(stats, "merges")
        a, b = f // scap, f % scap
        ai, aj = torch.minimum(a, b), torch.maximum(a, b)
        mm = (of2 == ai) | (of2 == aj)
        of2 = torch.where(mm, t, of2)
        xi, xj = _take(X, ai)[0], _take(X, aj)[0]
        row = xi + xj
        dg = (_take(xi, ai) + _take(xj, aj)) + 2.0 * _take(xi, aj)
        X[t, :] = row
        X[:, t] = row
        X[t, t:t + 1] = dg
        gnew = _take(sizes, ai) + _take(sizes, aj)
        sizes[t:t + 1] = gnew
        ij = torch.cat([ai, aj])
        alive.index_fill_(0, ij, False)
        alive[t] = True
        act.index_fill_(0, ij, False)
        act[t] = True
        # the new group's density row, host op order:
        # (within[-1] + within[:-1]) + Xn[-1, :-1]
        wt = dg / 2.0
        wl = torch.diagonal(X) / 2.0
        e_row = (wt + wl) + X[t, :]
        okr = (gnew + sizes) == omega
        dr = torch.where(okr, e_row / e_max, -1.0)
        dr = torch.where(dr >= gamma32, dr, -1.0)
        validc = act & alive & (slot != t)
        dr = torch.where(validc, dr, -2.0)
        D.index_fill_(0, ij, -2.0)
        D.index_fill_(1, ij, -2.0)
        D[t, :] = dr
        D[:, t] = dr
        D[t, t] = -2.0
        t += 1
        n_act -= 1

    # host output order: cand-universe groups first (act survivors and
    # untouched non-act cand in input position, merged appended in
    # creation order), rest groups after, both ascending
    key_m = torch.where(slot < n_act0, slot_of_m, n + slot)
    iota_n = torch.arange(n, dtype=_I64, device=dev)
    key_p = torch.where(is_rest, (n + scap) + iota_n, iota_n)
    keys = torch.cat([key_m, key_p])                 # (scap + n,)
    return _dense_rank(keys[of2])


def _install_partition_device(carry, of_new, now, dt, *, n, seed_new):
    """``install_partition`` as segment reductions over the slot maps.

    A new slot matches iff all its members came from ONE old slot of the
    same member count.  Changed slots take the member-wise expiry min
    (fresh iff still beyond ``now``), else Alg.-1 window seeding on the
    seed-count argmax server.  The whole (n+1)-row state is rebuilt.
    Empty segments reduce to the dtype's max (min) as ``segment_min``
    (``segment_max``) gives them.
    """
    E_old, a_old = carry["E"], carry["anchor"]
    of_old, cnt_old = carry["of"], carry["cnt"]
    dev = E_old.device
    m = E_old.shape[1]
    cnt_new = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    cnt_new.index_add_(0, of_new, torch.ones(n, dtype=torch.float64,
                                              device=dev))
    slot_valid = cnt_new > 0.0
    mn = torch.full((n + 1,), _INT_MAX, dtype=_I64, device=dev).scatter_reduce_(
        0, of_new, of_old, "amin", include_self=True)
    mx = torch.full((n + 1,), _INT_MIN, dtype=_I64, device=dev).scatter_reduce_(
        0, of_new, of_old, "amax", include_self=True)
    cand = mn.clamp(0, n)
    matched = slot_valid & (mn == mx) & (cnt_old[cand] == cnt_new)
    item_E = E_old[of_old]                           # (n, m)
    min_E = torch.full((n + 1, m), float("inf"), dtype=torch.float64,
                       device=dev).scatter_reduce_(
        0, of_new[:, None].expand(n, m), item_E, "amin", include_self=True)
    fresh = torch.where(slot_valid[:, None] & (min_E > now), min_E, 0.0)
    row_max = fresh.max(dim=1).values
    anew = torch.where(row_max > 0.0, fresh.argmax(dim=1), -1)
    if seed_new:
        ssum = torch.zeros((n + 1, m), dtype=_I64, device=dev)
        ssum.index_add_(0, of_new, carry["seed"][:n])
        js = ssum.argmax(dim=1)
        need = slot_valid & ~matched & (row_max <= 0.0) & (cnt_new > 1.0)
        col = torch.arange(m, device=dev)[None, :]
        fresh = torch.where(need[:, None] & (col == js[:, None]),
                            now + dt[js][:, None], fresh)
        anew = torch.where(need, js, anew)
    E_new = torch.where(matched[:, None], E_old[cand], fresh)
    a_new = torch.where(matched, a_old[cand], anew)
    return E_new, a_new, cnt_new


def _cgm_boundary(carry, now, cspec, dt, item_sizes, stats, *, n, m, h,
                  wcap, uses_sizes, enable_split, enable_acm, seed_new,
                  use_kernels, gcap, full_merge):
    """One T_CG boundary, fully on the device: Alg. 2 -> 4 -> 3 -> install.

    Then resets the window buffers and rolls the compact CRM + hot index
    map into the previous-window carry slots.
    """
    with _span("cgm.window_crm"):
        hot_idx, valid_h, lut, raw, norm, binary = _window_crm_device(
            carry, cspec, n=n, h=h, wcap=wcap, use_kernels=use_kernels)
    W = norm.to(torch.float64)
    dev = W.device

    # Alg. 4 edge diff: removed edges live in the PREV hot space, added
    # edges in the CURRENT one; both index maps ascend in item id, so the
    # row-major nonzero order is the host's lexicographic edge order
    p_idx, pbin = carry["p_idx"], carry["pbin"]
    lut_prev = torch.full((n + 1,), -1, dtype=_I64, device=dev)
    lut_prev[p_idx] = torch.arange(h, dtype=_I64, device=dev)
    lut_prev[n] = -1
    ci = lut_prev[hot_idx]                           # cur slot -> prev slot
    pc = lut[p_idx]                                  # prev slot -> cur slot
    pcv = pc >= 0
    pcc = pc.clamp(min=0)
    cur_in_prev = binary[pcc][:, pcc] & pcv[:, None] & pcv[None, :]
    civ = ci >= 0
    cic = ci.clamp(min=0)
    prev_in_cur = pbin[cic][:, cic] & civ[:, None] & civ[None, :]
    triu_h = torch.triu(torch.ones((h, h), dtype=torch.bool, device=dev),
                        diagonal=1)
    remM = pbin & ~cur_in_prev & triu_h
    addM = binary & ~prev_in_cur & triu_h
    of = carry["of"]
    gsize = carry["cnt"][:n].to(_I64)
    with _span("cgm.adjust"):
        of, gsize = _adjust_partition(
            of, gsize, binary, W, hot_idx, lut, addM, remM, p_idx, cspec,
            stats, n=n, h=h, gcap=gcap)
    if enable_split:
        with _span("cgm.split"):
            of = _split_oversized(of, gsize, W, lut, cspec, stats, n=n,
                                  gcap=gcap)
    if enable_acm:
        with _span("cgm.merge"):
            of = _approx_merge(
                of, binary, hot_idx, valid_h, cspec, stats, n=n, h=h,
                use_kernels=use_kernels, full_merge=full_merge)
    with _span("cgm.install"):
        E_new, a_new, cnt_new = _install_partition_device(
            carry, of, now, dt, n=n, seed_new=seed_new)
    out = dict(
        carry, E=E_new, anchor=a_new, of=of, cnt=cnt_new, wlen=0,
        wcnt=torch.zeros(n + 1, dtype=_I64, device=dev),
        seed=torch.zeros((n + 1, m), dtype=_I64, device=dev),
        p_idx=hot_idx, pbin=binary, praw=raw, pnorm=norm,
    )
    if uses_sizes:
        vol = torch.zeros(n + 1, dtype=torch.float64, device=dev)
        out["vol"] = vol.index_add_(0, of, item_sizes)
    return out


# ---------------------------------------------------------------------------
# in-step event construction + the Alg. 5/6 cost step
# ---------------------------------------------------------------------------
def _first_last(sorted_keys):
    """Segment-start and segment-end flags of a sorted key vector."""
    diff = sorted_keys[1:] != sorted_keys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=sorted_keys.device)
    return torch.cat([one, diff]), torch.cat([diff, one])


def _event_step(carry, x, spec, *, kind, charge, uses_sizes, item_sizes,
                dt_e, n, m):
    """Deduplicated (request, clique) events + the const-dt replay step.

    Every (B*d) item slot maps to key ``r*(n+1)+cl`` (invalid slots ->
    clique n), a stable argsort groups them, and segment sums give the
    per-event counts; inert groups (invalid slots, request padding) write
    to the dump row.  The cost arithmetic is the reference's
    expression for expression, so the E/anchor trajectory is float for
    float the numpy engine's and cost sums differ only by summation order.
    ``E`` and ``anchor`` are updated in place.
    """
    E, anchor = carry["E"], carry["anchor"]
    of, cnt = carry["of"], carry["cnt"]
    dev = E.device
    K = n
    items = x["items"]                               # (B, d)
    B, d = items.shape
    NE = B * d
    valid = (items >= 0).reshape(NE)
    item = items.clamp(0, n - 1).reshape(NE)
    r = torch.arange(B, dtype=_I64, device=dev)[:, None].expand(B, d).reshape(NE)
    cl = torch.where(valid, of[item], K)
    key = r * (K + 1) + cl
    o = torch.argsort(key, stable=True)
    sk = key[o]
    first, _ = _first_last(sk)
    seg = torch.cumsum(first.to(_I64), 0) - 1
    vmask = valid[o]
    n_req = torch.zeros(NE, dtype=torch.float64, device=dev).index_add_(
        0, seg, vmask.to(torch.float64))
    # compact the unique keys into the event axis; unused tail entries get
    # an inert pad key (last request, dump clique)
    pad_key = (B - 1) * (K + 1) + K
    dst = torch.where(first, seg, NE)
    ev_key = torch.full((NE + 1,), pad_key, dtype=_I64, device=dev)
    ev_key.scatter_(0, dst, sk)
    ev_key = ev_key[:NE]
    ev_r = ev_key // (K + 1)
    ev_c = ev_key % (K + 1)
    j = x["servers"][ev_r]
    t = x["times"][ev_r]
    val = ev_c < K
    size = cnt[ev_c]
    if uses_sizes:
        isz = torch.where(vmask, item_sizes[item][o], 0.0)
        req_size = torch.zeros(NE, dtype=torch.float64, device=dev).index_add_(
            0, seg, isz)
        csize = carry["vol"][ev_c]
    else:
        csize = size
        req_size = n_req

    # (c, j) view: the stable sort keeps ascending request order in-group
    key_cj = ev_c * m + j
    o_cj = torch.argsort(key_cj, stable=True)
    kcs = key_cj[o_cj]
    first_cj_s, last_cj_s = _first_last(kcs)
    t_cj_s = t[o_cj]
    prev_t_s = torch.where(
        first_cj_s, 0.0,
        torch.cat([t_cj_s.new_zeros(1), t_cj_s[:-1]]))
    first_cj = torch.empty_like(first_cj_s).scatter_(0, o_cj, first_cj_s)
    prev_cj_t = torch.empty_like(prev_t_s).scatter_(0, o_cj, prev_t_s)

    # per-clique view: previous server within the clique group
    o_c = torch.argsort(ev_c, stable=True)
    cs = ev_c[o_c]
    first_c_s, last_c_s = _first_last(cs)
    j_c_s = j[o_c]
    prev_j_s = torch.where(
        first_c_s, -1, torch.cat([j_c_s.new_full((1,), -1), j_c_s[:-1]]))
    first_c = torch.empty_like(first_c_s).scatter_(0, o_c, first_c_s)
    prev_j = torch.empty_like(prev_j_s).scatter_(0, o_c, prev_j_s)

    # ---- the replay cost step (const dt: ``dt_e`` is dt[0] on the device) ----
    E_before = torch.where(first_cj, E[ev_c, j], prev_cj_t + dt_e)
    a0 = anchor[ev_c]
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
    nm = miss.sum()
    carry["acc"] += torch.stack([
        tc.sum(), cc.sum(), rent.sum(),
        nm.to(torch.float64), (val.sum() - nm).to(torch.float64),
        torch.where(miss, size, 0.0).sum(),
    ])

    # ---- state update on segment-last events (non-lasts -> dump) ----
    uc = torch.where(last_cj_s, kcs // m, K)
    uj = torch.where(last_cj_s, kcs % m, 0)
    E.index_put_((uc, uj), t_cj_s + dt_e)
    ac = torch.where(last_c_s, cs, K)
    a_cur = anchor[ac]
    aE = E[ac, a_cur.clamp(min=0)]                   # POST-update E
    t_c_s = t[o_c]
    upd = (a_cur < 0) | (t_c_s + dt_e >= aE)
    anchor.index_put_((torch.where(upd, ac, K),), j_c_s)
    return carry


# ---------------------------------------------------------------------------
# host seam: carry init, execution, state/policy sync
# ---------------------------------------------------------------------------
def init_cgm_carry(state, prev_crm, win_prefix, *, schedule, uses_sizes,
                   item_sizes, device):
    """Host engine/policy state -> the device carry.

    The carry is dense-n (``of``: n slots, ``E``: (n+1, m)).  The compact
    workspace dims come from the ``schedule``; ``h`` is bumped to fit a
    restored previous-window CRM, and ``win_prefix`` puts an open
    window's already-fed requests into the buffer.
    """
    n, m = schedule.n, schedule.m
    h, wcap, dbuf = schedule.h, schedule.wcap, schedule.d
    prev_nh = int(prev_crm.hot_items.size) if prev_crm is not None else 0
    if prev_nh:
        h = min(n, max(h, _bucket(prev_nh, 32, 32)))

    of0 = np.asarray(state.partition.clique_of, np.int64)
    host = {
        "of": of0,
        "cnt": np.bincount(of0, minlength=n + 1).astype(np.float64),
        "acc": np.zeros(N_ACC, np.float64),
        "wbuf": np.full((wcap, dbuf), -1, np.int64),
        "wcnt": np.zeros(n + 1, np.int64),
        "seed": np.zeros((n + 1, m), np.int64),
        "p_idx": np.full(h, n, np.int64),
        "praw": np.zeros((h, h), np.float32),
        "pnorm": np.zeros((h, h), np.float32),
        "pbin": np.zeros((h, h), bool),
    }
    wlen = 0
    if uses_sizes:
        vol = np.zeros(n + 1, np.float64)
        np.add.at(vol, of0, np.asarray(item_sizes, np.float64))
        host["vol"] = vol
    if prev_nh:
        host["p_idx"][:prev_nh] = np.asarray(prev_crm.hot_items, np.int64)
        host["praw"][:prev_nh, :prev_nh] = np.asarray(prev_crm.raw,
                                                      np.float32)
        host["pnorm"][:prev_nh, :prev_nh] = prev_crm.norm
        host["pbin"][:prev_nh, :prev_nh] = prev_crm.binary
    if win_prefix is not None:
        p_it, p_sv = win_prefix
        p_it = np.atleast_2d(np.asarray(p_it))
        R0 = int(p_it.shape[0])
        if R0:
            if R0 > wcap or p_it.shape[1] > dbuf:
                raise ValueError(
                    f"window prefix ({R0} x {p_it.shape[1]}) exceeds the "
                    f"carry buffer ({wcap} x {dbuf}); build the schedule "
                    "with prefix_rows/prefix_slots")
            host["wbuf"][:R0, : p_it.shape[1]] = p_it
            wlen = R0
            flat = p_it.reshape(-1)
            host["wcnt"] = np.bincount(
                np.where(flat >= 0, flat, n), minlength=n + 1).astype(np.int64)
            sv = np.repeat(np.asarray(p_sv, np.int64), p_it.shape[1])
            ok = flat >= 0
            np.add.at(host["seed"], (flat[ok], sv[ok]), 1)
    carry = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    carry["E"], carry["anchor"] = state_to_device(state, n, device)
    carry["wlen"] = wlen
    return carry


def cgm_loop_statics(cspec, carry0, *, enable_acm):
    """The two loop capacities derived from the spec.

    * ``gcap`` — member-list width: no group can exceed max(initial
      partition, omega), bucketed;
    * ``full_merge`` — True when the approximate merge runs outside the
      pruning regime (the w/o-CS ablation: omega = n), so the act space
      must hold all n groups (``scap = 2n``) instead of ``2h``.
    """
    om = int(cspec["omega"])
    gam = float(cspec["gamma"])
    prune = om > 2 and gam > (om - 2.0) / om
    full_merge = bool(enable_acm) and not prune
    cnt_max = int(carry0["cnt"].max().item())
    gcap = _bucket(max(om, cnt_max, 2), 8, 8)
    return gcap, full_merge


def run_cgm_schedule(schedule, spec, statics, cspec, carry0, item_sizes, *,
                     charge="requested", enable_split=True, enable_acm=True,
                     seed_new=True, use_kernels=True):
    """Execute one CGM schedule on the carry's device.

    Returns ``(final_carry, boundary_ofs, stats)``: the carry after the
    last step, the slot map after each boundary (stacked, on the device)
    and the loop counts: host syncs by kind (``sync_*``), removed and
    added edges walked, split worklist pops and merges.  The request tensors go to the
    device in one transfer; steps without requests are skipped (the
    schedule pads its step count to a bucket).
    """
    dev = carry0["E"].device
    n, m = schedule.n, schedule.m
    h = carry0["p_idx"].shape[0]
    wcap = carry0["wbuf"].shape[0]
    gcap, full_merge = cgm_loop_statics(cspec, carry0, enable_acm=enable_acm)
    spec_d = spec_to_device(spec, dev)
    dt = spec_d["dt"]
    # dt[0] as a device scalar, not a Python float: CUDA divides a tensor
    # by a host scalar as a product with its reciprocal, which can round
    # differently from the numpy engine's division
    dt_e = dt[0]
    uses_sizes = "vol" in carry0
    sz = (torch.as_tensor(np.asarray(item_sizes, np.float64), device=dev)
          if item_sizes is not None else None)
    xs = schedule.xs
    items = torch.as_tensor(xs["items"].astype(np.int64), device=dev)
    servers = torch.as_tensor(xs["servers"].astype(np.int64), device=dev)
    times = torch.as_tensor(xs["times"], dtype=torch.float64, device=dev)
    stats: dict = {}
    carry = dict(carry0)
    ofs = []
    for b in range(schedule.nb):
        nreq = int(xs["nreq"][b])
        if xs["cg"][b]:
            with _span("cgm.boundary"):
                carry = _cgm_boundary(
                    carry, float(xs["now"][b]), cspec, dt, sz, stats, n=n,
                    m=m, h=h, wcap=wcap, uses_sizes=uses_sizes,
                    enable_split=enable_split, enable_acm=enable_acm,
                    seed_new=seed_new, use_kernels=use_kernels, gcap=gcap,
                    full_merge=full_merge)
            ofs.append(carry["of"])
        if nreq == 0:
            continue
        x = {"items": items[b], "servers": servers[b], "times": times[b],
             "nreq": nreq}
        with _span("replay.step"):
            carry = _accumulate_window(carry, x, n=n)
            carry = _event_step(
                carry, x, spec_d, kind=statics, charge=charge,
                uses_sizes=uses_sizes, item_sizes=sz, dt_e=dt_e, n=n, m=m)
    ofs = (torch.stack(ofs) if ofs
           else torch.zeros((0, n), dtype=_I64, device=dev))
    return carry, ofs, stats


def replay_cgm(jeng, policy, trace, *, t_cg, batch_size=None, next_cg0=None,
               win_prefix=None, use_kernels=True):
    """Device AKPC replay: one host->device transfer, zero host
    clique-generation calls.  The state, costs and the policy's window
    bookkeeping come back to the host at the end."""
    eng = jeng.engine
    dev = jeng.device
    uses_sizes = bool(eng.model.uses_sizes)
    item_sizes = eng.env.sizes() if uses_sizes else None
    prefix_rows = prefix_slots = 0
    if win_prefix is not None:
        p_it = np.atleast_2d(np.asarray(win_prefix[0]))
        prefix_rows = int(p_it.shape[0])
        prefix_slots = prefix_rows * max(1, int(p_it.shape[1]))
    schedule = build_cgm_schedule(
        trace, t_cg, uses_sizes=uses_sizes, batch_size=batch_size,
        next_cg0=next_cg0, hot_dims=policy_hot_dims(policy),
        prefix_rows=prefix_rows, prefix_slots=prefix_slots)
    jeng.last_schedule = schedule
    cfg = policy.config
    cspec = cgm_spec(cfg, cfg.params, trace.n)
    carry0 = init_cgm_carry(
        eng.state, getattr(policy, "_prev_crm", None), win_prefix,
        schedule=schedule, uses_sizes=uses_sizes, item_sizes=item_sizes,
        device=dev)
    final, ofs, stats = run_cgm_schedule(
        schedule, jeng._spec, jeng._statics, cspec, carry0, item_sizes,
        charge=eng.caching_charge,
        enable_split=cfg.enable_split,
        enable_acm=cfg.enable_approx_merge,
        seed_new=eng.seed_new_cliques,
        use_kernels=use_kernels)
    jeng.last_stats = stats
    host = {k: final[k].cpu().numpy()
            for k in ("E", "anchor", "of", "acc", "p_idx", "praw", "pnorm",
                      "pbin")}
    nbd = int(schedule.boundary_steps.size)
    part = (eng.state.partition if nbd == 0
            else partition_from_of(trace.n, host["of"]))
    eng.state = CacheState(
        partition=part, E=host["E"][: part.k].copy(),
        anchor=host["anchor"][: part.k].astype(np.int32), m=eng.m)
    eng._set_partition_caches(part)
    apply_acc(eng.costs, schedule, host["acc"])
    boundary_ofs = ofs.cpu().numpy()
    per_step = {int(b): boundary_ofs[i]
                for i, b in enumerate(schedule.boundary_steps)}
    sync_policy_from_run(policy, schedule, per_step, host, part)
    return eng.costs
