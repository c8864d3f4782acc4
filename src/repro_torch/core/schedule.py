"""The host-built replay schedule: the padded event tensors of a whole trace.

The host half of ``repro.core.engine_jax``'s host-schedule replay.
Everything that is a pure function of (trace, clique generation) and NOT
of cache state is computed here, once, on the host: the T_CG window walk,
the policy's clique generation at every boundary, the per-batch
(request, clique) event construction of
:func:`~repro_torch.core.engine.batch_events` (dedup, sort orders, lags,
segment flags; the item -> clique lookup runs through ``packed_lookup``
on the device), and the partition-install matching.  It is packed into
fixed-shape, padded step tensors that :func:`repro_torch.core.replay.run_schedule`
uploads once and scans on the device.

Padding points at the dump row K (the last state row): padded events,
compacted writes and install rows write there and nowhere else.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .cliques import CliquePartition
from .cost import CacheEnvironment, CostModel
from .engine import (
    DEFAULT_BATCH_SIZE,
    _numpy_clique_lookup,
    batch_events,
    match_partitions,
    window_seed_servers,
)
from .replay import NE_TARGET, _bucket
from .state_layout import StateLayout


@dataclasses.dataclass
class ReplaySchedule:
    """Fixed-shape padded event tensors of one trace replay (host numpy).

    ``xs[key]`` has leading axis nb (scan steps); event axis padded to
    ``ne``; install arrays padded to n rows (+ dump).  The schedule holds
    no cache state, so one schedule serves every scenario that shares
    (trace, clique-generation hyperparameters).
    """

    n: int
    m: int
    nb: int
    ne: int
    const_dt: bool
    uses_sizes: bool
    xs: dict
    n_requests: int
    n_item_requests: int
    partition0: CliquePartition
    final_partition: CliquePartition
    win_start: int              # open-window start index into the trace
    boundary_hit: bool          # did any Event-1 boundary fire in this trace
    next_cg: float | None       # T_CG boundary after the last request
    # state geometry the index fills were built for (StateLayout.state_dims;
    # dense default = (n + 1, m)); the dump row is always nrow - 1
    nrow: int = 0
    ncol: int = 0

    @property
    def state_rows(self) -> int:
        return self.nrow if self.nrow else self.n + 1

    @property
    def state_cols(self) -> int:
        return self.ncol if self.ncol else self.m


def _part_cost_arrays(part: CliquePartition, item_sizes: np.ndarray | None):
    """Per-clique member counts + total volumes (engine _set_partition_caches)."""
    sizes = part.sizes().astype(np.int64)
    if item_sizes is None or part.k == 0:
        return sizes, None
    order = part.member_order()
    starts = np.zeros(part.k, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    return sizes, np.add.reduceat(item_sizes[order], starts)


def build_schedule(
    partition0: CliquePartition,
    trace,
    clique_generator: Callable | None,
    t_cg: float | None,
    *,
    model: CostModel,
    env: CacheEnvironment,
    batch_size: int | None = None,
    seed_new_cliques: bool = True,
    next_cg0: float | None = None,
    win_prefix: tuple[np.ndarray, np.ndarray] | None = None,
    lookup: Callable | None = None,
    progress: Callable[[int], None] | None = None,
    layout: StateLayout | str | None = None,
) -> ReplaySchedule:
    """Walk the trace exactly as ``ReplayEngine.replay`` does and emit the
    padded event tensors + install records of every batch.

    ``next_cg0``/``win_prefix`` support mid-stream continuation (a
    replay resumed with an already-open T_CG window); fresh replays leave
    them None.  ``lookup`` maps items to cliques (default: the host
    gather); ``batch_size=None`` cuts each window into event-balanced
    batches of about ``NE_TARGET`` events.
    """
    n, m = env.n, env.m
    lay = StateLayout.resolve(layout)
    nrow, ncol = lay.state_dims(n, m)
    K = nrow - 1                                # dump row index (last row)
    bs = DEFAULT_BATCH_SIZE if batch_size is None else max(1, int(batch_size))
    lookup = lookup or _numpy_clique_lookup
    uses_sizes = bool(model.uses_sizes)
    item_sizes = env.sizes() if uses_sizes else None
    dt_arr = np.asarray(model.dt(), dtype=np.float64)
    const_dt = m == 0 or bool((dt_arr == dt_arr[0]).all())

    times, servers, items = trace.times, trace.servers, trace.items
    R = int(times.shape[0])
    cur = partition0
    sizes_c, csizes_c = _part_cost_arrays(cur, item_sizes)

    # keep-or-not (TTL) hook: a policy exposing ``item_keep()`` on the
    # generator's bound object ships a per-event nokeep mask plus boundary
    # eviction rows through the schedule — the device mirror of
    # ``ReplayEngine.set_item_keep`` (engine.py)
    keep_fn = None
    if clique_generator is not None:
        pol = getattr(clique_generator, "__self__", None)
        keep_fn = getattr(pol, "item_keep", None)

    def _clique_nk_of(part: CliquePartition, keep: np.ndarray) -> np.ndarray:
        """Clique-level nokeep mask: nokeep iff ANY member is nokeep."""
        if part.k == 0:
            return np.zeros(0, bool)
        psz = part.sizes().astype(np.int64)
        order = part.member_order()
        starts = np.zeros(part.k, np.int64)
        np.cumsum(psz[:-1], out=starts[1:])
        return np.add.reduceat((~keep)[order].astype(np.int64), starts) > 0

    cur_keep = (np.asarray(keep_fn(), bool).copy()
                if keep_fn is not None else None)
    cur_nk = _clique_nk_of(cur, cur_keep) if cur_keep is not None else None

    batches: list[dict] = []
    pending_install: dict | None = None
    n_requests = 0
    n_item_requests = 0

    def _emit(pos: int, stop: int) -> None:
        nonlocal pending_install, n_requests, n_item_requests
        ev = batch_events(
            cur.clique_of, cur.k, m,
            np.atleast_2d(items[pos:stop]), servers[pos:stop],
            times[pos:stop], lookup,
            item_sizes if csizes_c is not None else None,
        )
        n_requests += stop - pos
        n_item_requests += ev.n_valid
        size_e = sizes_c[ev.ev_c].astype(np.float64)
        csize_e = (csizes_c[ev.ev_c] if csizes_c is not None else size_e)
        n_req = ev.n_req.astype(np.float64)
        req_size = (ev.req_size if ev.req_size is not None else n_req)
        rec = {
            "ev": ev, "size": size_e, "csize": csize_e,
            "n_req": n_req, "req_size": np.asarray(req_size, np.float64),
            "install": pending_install,
        }
        if cur_nk is not None:
            rec["nk"] = (cur_nk[ev.ev_c] if ev.n_events
                         else np.zeros(0, bool))
        pending_install = None
        batches.append(rec)

    def _record_install(part: CliquePartition, now: float,
                        w_it: np.ndarray, w_sv: np.ndarray) -> None:
        nonlocal pending_install, cur, sizes_c, csizes_c, cur_keep, cur_nk
        if pending_install is not None:     # two Event-1s with no requests
            _emit(0, 0)                     # between them: flush on an
            # empty batch so installs stay one-per-scan-step
        matched, cand = match_partitions(cur, part)
        k = part.k
        new_sizes = part.sizes().astype(np.int64)
        # COMPACT translation: only CHANGED cliques need the member-wise
        # segment-min / seeding — matched rows are a plain row gather via
        # ``cand``.  Windows drift slowly, so the device install touches
        # O(changed x m), not O(n x m).
        chg = np.nonzero(~matched)[0]
        order = part.member_order()
        starts = np.zeros(k, np.int64)
        np.cumsum(new_sizes[:-1], out=starts[1:])
        chg_item = (
            np.concatenate(
                [order[starts[c]: starts[c] + new_sizes[c]] for c in chg])
            if chg.size else np.zeros(0, np.int64))
        chg_seg = np.repeat(np.arange(chg.size), new_sizes[chg])
        seed_j = np.zeros(chg.size, np.int32)
        seed_ok = np.zeros(chg.size, bool)
        if seed_new_cliques and w_it is not None and k > 0 and chg.size:
            js = window_seed_servers(n, m, part, w_it, w_sv)
            seed_j = js[chg].astype(np.int32)
            seed_ok = new_sizes[chg] > 1
            if cur_keep is not None:
                # OLD-mask guard (engine install_partition): never seed a
                # clique holding a keep-or-not evicted item
                has_nk = np.bincount(
                    chg_seg,
                    weights=(~cur_keep)[chg_item].astype(np.float64),
                    minlength=chg.size) > 0
                seed_ok &= ~has_nk
        # matched cliques that KEPT their index need no write at all — in
        # the steady state (partition drifting slowly) the whole install
        # reduces to a handful of row scatters
        mov = np.nonzero(matched & (cand != np.arange(k)))[0]
        chg_ok = np.ones(chg.size, bool)
        if keep_fn is not None:
            # NEW-mask boundary eviction (engine set_item_keep): cliques
            # holding an item that just flipped keep->nokeep drop their
            # copies.  Rows already in chg flip ok=False (the install step
            # turns ok=False rows into E=0 / anchor=-1); other evicted
            # rows join chg as member-less ok=False rows; moved copies of
            # evicted cliques are dropped from the row-move list.
            new_keep = np.asarray(keep_fn(), bool).copy()
            newly_nk = cur_keep & ~new_keep
            if newly_nk.any():
                ev_rows = np.unique(
                    part.clique_of[np.nonzero(newly_nk)[0]]).astype(np.int64)
                evict = np.zeros(k, bool)
                evict[ev_rows] = True
                chg_ok[evict[chg]] = False
                mov = mov[~evict[mov]]
                extra = ev_rows[~np.isin(ev_rows, chg)]
                chg = np.concatenate([chg, extra])
                chg_ok = np.concatenate(
                    [chg_ok, np.zeros(extra.size, bool)])
                seed_j = np.concatenate(
                    [seed_j, np.zeros(extra.size, np.int32)])
                seed_ok = np.concatenate(
                    [seed_ok, np.zeros(extra.size, bool)])
            cur_keep = new_keep
            cur_nk = _clique_nk_of(part, new_keep)
        pending_install = {
            "now": np.float64(now),
            "mov_dst": mov.astype(np.int32),
            "mov_src": cand[mov].astype(np.int32),
            "chg_rows": chg.astype(np.int32),
            "chg_ok": chg_ok,
            "chg_src": cur.clique_of[chg_item].astype(np.int32),
            "chg_seg": chg_seg.astype(np.int32),
            "seed_j": seed_j,
            "seed_ok": seed_ok,
        }
        cur = part
        sizes_c, csizes_c = _part_cost_arrays(cur, item_sizes)

    # -- the T_CG boundary walk (mirrors ReplayEngine.replay) --------------
    use_cg = clique_generator is not None and t_cg is not None
    balanced = batch_size is None      # event-balanced default slicing
    if balanced and R > 0:
        cum = np.zeros(R + 1, np.int64)
        np.cumsum((items >= 0).sum(axis=1), out=cum[1:])
    if R > 0:
        if next_cg0 is not None:
            next_cg = float(next_cg0)
        else:
            next_cg = float(times[0]) + t_cg if t_cg is not None else np.inf
    else:
        next_cg = next_cg0 if next_cg0 is not None else np.inf
    win_start = 0
    boundary_hit = False
    pos = 0
    next_prog = 0
    while pos < R:
        cut = R
        if use_cg:
            cut = int(np.searchsorted(times, next_cg, side="left"))
            if cut <= pos:
                t = float(times[pos])
                w_it = items[win_start:pos]
                w_sv = servers[win_start:pos]
                if win_prefix is not None:
                    p_it, p_sv = win_prefix
                    if p_it.shape[0]:
                        d = max(int(p_it.shape[1]), int(w_it.shape[1]))
                        full = np.full(
                            (p_it.shape[0] + w_it.shape[0], d), -1, np.int64)
                        full[: p_it.shape[0], : p_it.shape[1]] = p_it
                        if w_it.shape[0]:
                            full[p_it.shape[0]:, : w_it.shape[1]] = w_it
                        w_it = full
                        w_sv = np.concatenate(
                            [np.asarray(p_sv, np.int64),
                             np.asarray(w_sv, np.int64)])
                    win_prefix = None
                part = clique_generator(w_it, w_sv, t)
                if part is not None:
                    _record_install(part, t, w_it, w_sv)
                elif keep_fn is not None and not np.array_equal(
                        cur_keep, np.asarray(keep_fn(), bool)):
                    # mask moved without a new partition: identity install
                    # record carrying only the boundary evictions
                    _record_install(cur, t, w_it, w_sv)
                win_start = pos
                boundary_hit = True
                while next_cg <= t:
                    next_cg += t_cg
                continue
        if balanced:
            # split [pos, cut) into equal-EVENT batches (any chunking
            # reproduces the costs at 1e-9, so the device schedule is free
            # to pick dense slices)
            est = int(cum[cut] - cum[pos])
            nbat = max(1, -(-est // NE_TARGET))
            prev = pos
            for kb in range(1, nbat + 1):
                if kb == nbat:
                    stop = cut
                else:
                    target = cum[pos] + (est * kb) // nbat
                    stop = int(np.searchsorted(cum, target, side="left"))
                    stop = min(max(stop, prev + 1), cut)
                if stop > prev:
                    _emit(prev, stop)
                    prev = stop
            pos = cut
        else:
            stop = min(pos + bs, cut)
            _emit(pos, stop)
            pos = stop
        if progress is not None and pos >= next_prog:
            progress(pos)
            next_prog = (pos | 0xFFFF) + 1
    if pending_install is not None:         # trailing Event 1, no requests
        _emit(0, 0)

    # -- stack + pad into fixed-shape tensors -------------------------------
    # nu / na: compacted per-step state-update widths — scatters touch only
    # the segment-last events ((c,j) pairs / cliques), not the full event
    # axis
    nb_raw = len(batches)
    nb = _bucket(nb_raw, 4, 4)
    ne = _bucket(max((r["ev"].n_events for r in batches), default=1), 256, 64)
    nu = _bucket(
        max((int(r["ev"].last_cj_s.sum()) for r in batches), default=1),
        128, 32)
    na = _bucket(
        max((int(r["ev"].last_c_s.sum()) for r in batches), default=1),
        32, 32)
    installs = [r["install"] for r in batches if r["install"] is not None]
    # +1 slack: the last compact row/segment is always padding, so padded
    # items can never corrupt a real segment's min
    ncr = _bucket(
        max((i["chg_rows"].size for i in installs), default=0) + 1, 8, 8)
    nci = _bucket(
        max((i["chg_src"].size for i in installs), default=0) + 1, 16, 16)
    nmv = _bucket(
        max((i["mov_dst"].size for i in installs), default=0), 8, 8)

    def zeros(dtype, *shape):
        return np.zeros((nb, *shape), dtype)

    xs = {
        "ev_c": np.full((nb, ne), K, np.int32),
        "ev_j": zeros(np.int32, ne),
        "ev_t": zeros(np.float64, ne),
        "n_req": zeros(np.float64, ne),
        "size": zeros(np.float64, ne),
        "val": zeros(bool, ne),
        "first_cj": zeros(bool, ne),
        "prev_cj_t": zeros(np.float64, ne),
        # compacted (c, j) expiry writes + per-clique anchor writes
        "upd_c": np.full((nb, nu), K, np.int32),
        "upd_j": zeros(np.int32, nu),
        "anc_c": np.full((nb, na), K, np.int32),
        "inst": zeros(bool),
        "inst_now": zeros(np.float64),
        "inst_mov_dst": np.full((nb, nmv), K, np.int32),
        "inst_mov_src": np.full((nb, nmv), K, np.int32),
        "inst_chg_rows": np.full((nb, ncr), K, np.int32),
        "inst_chg_ok": zeros(bool, ncr),
        "inst_seed_j": zeros(np.int32, ncr),
        "inst_seed_ok": zeros(bool, ncr),
        "inst_chg_src": zeros(np.int32, nci),
        "inst_chg_seg": np.full((nb, nci), ncr - 1, np.int32),
    }
    if keep_fn is not None:
        # presence keyed on the HOOK, not the mask content: an all-keep
        # window still ships the (all-False) tensor, so the step takes the
        # same branch in every chunk of a stream
        xs["nokeep"] = zeros(bool, ne)
    if uses_sizes:
        # count-based models (table1) read size/n_req twice instead of
        # shipping duplicate volume tensors through the scan
        xs["csize"] = zeros(np.float64, ne)
        xs["req_size"] = zeros(np.float64, ne)
    if const_dt:
        xs.update(
            first_c=zeros(bool, ne),
            prev_j=np.full((nb, ne), -1, np.int32),
            upd_t=zeros(np.float64, nu),
            anc_j=zeros(np.int32, na),
            anc_t=zeros(np.float64, na),
        )
    else:
        xs.update(
            inv_o_c=zeros(np.int32, ne),
            c_s=np.full((nb, ne), K, np.int32),
            j_s=zeros(np.int32, ne),
            t_s=zeros(np.float64, ne),
            first_cs=np.ones((nb, ne), bool),
            cj_j_s=zeros(np.int32, ne),
            cj_t_s=zeros(np.float64, ne),
            first_cjs=np.ones((nb, ne), bool),
            pos_u=zeros(np.int32, nu),
            pos_a=zeros(np.int32, na),
        )

    for b, rec in enumerate(batches):
        ev = rec["ev"]
        e = ev.n_events
        if e:
            xs["ev_c"][b, :e] = ev.ev_c
            xs["ev_j"][b, :e] = ev.ev_j
            xs["ev_t"][b, :e] = ev.ev_t
            xs["n_req"][b, :e] = rec["n_req"]
            xs["size"][b, :e] = rec["size"]
            if uses_sizes:
                xs["req_size"][b, :e] = rec["req_size"]
                xs["csize"][b, :e] = rec["csize"]
            xs["val"][b, :e] = True
            xs["first_cj"][b, :e] = ev.first_cj
            xs["prev_cj_t"][b, :e] = ev.prev_cj_t
            li = ev.o_cj[ev.last_cj_s]          # one event per (c, j) pair
            lc = ev.o_c[ev.last_c_s]            # one event per clique
            nk_e = rec.get("nk")
            if nk_e is not None:
                xs["nokeep"][b, :e] = nk_e
                # nokeep cliques never store state: route their compacted
                # expiry/anchor writes to the dump row
                xs["upd_c"][b, : li.size] = np.where(
                    nk_e[li], K, ev.ev_c[li])
                xs["anc_c"][b, : lc.size] = np.where(
                    nk_e[lc], K, ev.ev_c[lc])
            else:
                xs["upd_c"][b, : li.size] = ev.ev_c[li]
                xs["anc_c"][b, : lc.size] = ev.ev_c[lc]
            xs["upd_j"][b, : li.size] = ev.ev_j[li]
            if const_dt:
                xs["first_c"][b, :e] = ev.first_c
                xs["prev_j"][b, :e] = ev.prev_j
                xs["upd_t"][b, : li.size] = ev.ev_t[li]
                xs["anc_j"][b, : lc.size] = ev.ev_j[lc]
                xs["anc_t"][b, : lc.size] = ev.ev_t[lc]
            else:
                inv = np.empty(e, np.int32)
                inv[ev.o_c] = np.arange(e, dtype=np.int32)
                xs["inv_o_c"][b, :e] = inv
                xs["c_s"][b, :e] = ev.cs
                xs["j_s"][b, :e] = ev.ev_j[ev.o_c]
                xs["t_s"][b, :e] = ev.ev_t[ev.o_c]
                xs["first_cs"][b, :e] = ev.first_c_s
                xs["cj_j_s"][b, :e] = ev.ev_j[ev.o_cj]
                xs["cj_t_s"][b, :e] = ev.ev_t[ev.o_cj]
                xs["first_cjs"][b, :e] = ev.first_cj_s
                xs["pos_u"][b, : li.size] = np.nonzero(ev.last_cj_s)[0]
                xs["pos_a"][b, : lc.size] = np.nonzero(ev.last_c_s)[0]
        inst = rec["install"]
        if inst is not None:
            nr = inst["chg_rows"].size
            ni = inst["chg_src"].size
            nv = inst["mov_dst"].size
            xs["inst"][b] = True
            xs["inst_now"][b] = inst["now"]
            xs["inst_mov_dst"][b, :nv] = inst["mov_dst"]
            xs["inst_mov_src"][b, :nv] = inst["mov_src"]
            xs["inst_chg_rows"][b, :nr] = inst["chg_rows"]
            xs["inst_chg_ok"][b, :nr] = inst["chg_ok"]
            xs["inst_seed_j"][b, :nr] = inst["seed_j"]
            xs["inst_seed_ok"][b, :nr] = inst["seed_ok"]
            xs["inst_chg_src"][b, :ni] = inst["chg_src"]
            xs["inst_chg_seg"][b, :ni] = inst["chg_seg"]

    return ReplaySchedule(
        n=n, m=m, nb=nb, ne=ne, const_dt=const_dt, uses_sizes=uses_sizes,
        xs=xs, n_requests=n_requests, n_item_requests=n_item_requests,
        partition0=partition0, final_partition=cur,
        win_start=win_start, boundary_hit=boundary_hit,
        next_cg=None if not use_cg or R == 0 else float(next_cg),
        nrow=nrow, ncol=ncol,
    )


def schedule_dims(s: ReplaySchedule) -> dict:
    """The padded axis sizes of a schedule (for cross-schedule alignment)."""
    return {"nb": s.nb, "ne": s.ne,
            "nu": s.xs["upd_c"].shape[1], "na": s.xs["anc_c"].shape[1],
            "ncr": s.xs["inst_chg_rows"].shape[1],
            "nci": s.xs["inst_chg_src"].shape[1],
            "nmv": s.xs["inst_mov_dst"].shape[1]}


def pad_schedule(s: ReplaySchedule, dims: dict) -> ReplaySchedule:
    """Pad a schedule's tensors up to ``dims`` (a superset of its own).

    Padded steps and slots are inert by the same masking rules as
    intra-schedule padding, so a replay of the padded schedule equals one
    of the original.
    """
    mine = schedule_dims(s)
    if mine == dims:
        return s
    K = s.state_rows - 1
    old_ncr = mine["ncr"]
    fills = {
        "ev_c": K, "upd_c": K, "anc_c": K, "c_s": K,
        "inst_mov_dst": K, "inst_mov_src": K, "inst_chg_rows": K,
        "first_cs": True, "first_cjs": True,
        "prev_j": -1,
        "inst_chg_seg": dims["ncr"] - 1,
    }
    axis_of = {
        "upd_c": "nu", "upd_j": "nu", "upd_t": "nu", "pos_u": "nu",
        "anc_c": "na", "anc_j": "na", "anc_t": "na", "pos_a": "na",
        "inst_chg_rows": "ncr", "inst_chg_ok": "ncr",
        "inst_seed_j": "ncr", "inst_seed_ok": "ncr",
        "inst_mov_dst": "nmv", "inst_mov_src": "nmv",
        "inst_chg_src": "nci", "inst_chg_seg": "nci",
    }
    xs = {}
    for key, a in s.xs.items():
        # real segment ids never collide with the pad sentinel (values
        # <= ncr-2 by the +1 slack), so remapping it is unambiguous
        if key == "inst_chg_seg":
            a = np.where(a == old_ncr - 1, dims["ncr"] - 1, a)
        want = [dims["nb"]]
        if a.ndim == 2:
            want.append(dims[axis_of.get(key, "ne")])
        if list(a.shape) != want:
            out = np.full(want, fills.get(key, 0), a.dtype)
            out[tuple(slice(0, d) for d in a.shape)] = a
            a = out
        xs[key] = a
    return dataclasses.replace(s, nb=dims["nb"], ne=dims["ne"], xs=xs)
