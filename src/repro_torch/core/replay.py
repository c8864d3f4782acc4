"""The device replay: cost hooks, state transfer, the replay scan, engine, driver.

The device half of ``repro.core.engine_jax``:

* :func:`cost_spec` turns a cost model into per-server arrays plus a static
  kind, and :func:`_transfer_hook` / :func:`_rate_hook` price events from
  them on the device (table1, tiered, heterogeneous);
* :func:`state_to_device` / :func:`apply_acc` move state and cost totals
  between the host :class:`~repro_torch.core.engine.CacheState` /
  :class:`~repro_torch.core.cost.CostBreakdown` and the device;
* :func:`run_schedule` is the host-schedule replay scan: the state
  recurrence (expiries ``E``, Alg.-6 ``anchor``, ratcheting, Alg.-5 cost
  accounting, partition installs) over the padded step tensors of a
  :class:`~repro_torch.core.schedule.ReplaySchedule`.  ``lax.scan`` is a
  Python loop over steps; ``E`` and ``anchor`` are updated in place; the
  step branches only on host values, so the loop makes no device sync.
  Under per-server dt the anchor resolution and the pair expiries are
  the two scans of one ``seg_scan_step`` launch a step.  The state
  may carry a leading axis of S scenario lanes (``E`` (S, n+1, m),
  ``anchor`` (S, n+1), spec arrays with a leading S) that share the
  schedule's event tensors: one scan prices S scenarios, as the
  reference's ``jax.vmap`` with the schedule unbatched does;
* :func:`run_schedules` runs lanes that each replay a schedule of their
  own (the sweep's trace shards and cohorts) in one scan: the distinct
  schedules go up once as (G, ...) rows, each lane reads its row, and a
  step's scans are one ``seg_scan_step`` launch over the rows;
* :class:`TorchReplayEngine` and :func:`run_policy_torch` are the
  counterparts of ``JaxReplayEngine`` and ``run_policy_jax``.

``replay`` routes as the reference does: an AKPC policy that
:func:`~repro_torch.core.cgm_schedule.wants_device_cgm` admits runs
:func:`repro_torch.core.cgm.replay_cgm` (clique generation on the
device); everything else builds the host schedule (clique generation on
the host, items -> cliques through ``packed_lookup``) and runs
:func:`run_schedule`.

Entry points take ``device=None``, which means ``"cuda"``: without CUDA
they raise unless the caller asked for ``device="cpu"``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .cost import (
    CacheEnvironment,
    CostBreakdown,
    CostModel,
    HeterogeneousCostModel,
    Table1CostModel,
    TieredCostModel,
)
from .engine import CacheState, ReplayEngine
from .state_layout import StateLayout

_I64 = torch.int64
#: named host spans for ``torch.profiler``
_span = torch.profiler.record_function

#: cost models the device hooks express
DEVICE_COST_MODELS = ("table1", "tiered", "heterogeneous")
#: target deduplicated events per replay step under default slicing
NE_TARGET = 8192
#: device cost accumulator slots: transfer, caching, keepalive rent,
#: misses, hits, items transferred
N_ACC = 6


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda.  Raises when CUDA is asked for but absent: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev


def _bucket(x: int, step: int, floor: int) -> int:
    """Round up to a multiple of ``step`` (>= floor)."""
    return max(floor, -(-x // step) * step)


def cost_spec(model: CostModel, env: CacheEnvironment) -> tuple[dict, tuple]:
    """(spec arrays, static key) reproducing ``model``'s batched hooks.

    ``spec`` is a dict of numpy arrays; the static key
    ``(kind, literal, n_tiers)`` selects the formula.
    """
    p = env.params
    spec = {
        "dt": np.asarray(model.dt(), dtype=np.float64),
        "alpha": np.float64(p.alpha),
        "lam": np.float64(p.lam),
        "mu": np.float64(p.mu),
        "lam_j": env.lam_per_server(),
        "mu_j": env.mu_per_server(),
        "tier_lo": np.zeros(0),
        "tier_hi": np.zeros(0),
        "tier_rates": np.zeros(0),
    }
    literal = p.cost_mode == "paper_literal"
    if isinstance(model, TieredCostModel):
        spec["tier_lo"] = model._lo.astype(np.float64)
        spec["tier_hi"] = model._hi.astype(np.float64)
        spec["tier_rates"] = model.rates.astype(np.float64)
        return spec, ("tiered", literal, int(model.rates.shape[0]))
    if isinstance(model, HeterogeneousCostModel):
        return spec, ("heterogeneous", literal, 0)
    if isinstance(model, Table1CostModel):
        return spec, ("table1", literal, 0)
    raise NotImplementedError(
        f"cost model {model.name!r} has no device formula; the port "
        f"supports {DEVICE_COST_MODELS}")


def spec_to_device(spec: dict, device) -> dict:
    """Scalars stay Python floats (f64 arithmetic on f64 tensors is the
    same as the reference's f64 arrays); arrays go to the device as f64."""
    out = {}
    for k, v in spec.items():
        a = np.asarray(v)
        out[k] = (float(a) if a.ndim == 0 else
                  torch.as_tensor(a, dtype=torch.float64, device=device))
    return out


def lane_spec_to_device(spec: dict, device, laned: bool) -> dict:
    """A spec in scenario-lane form on the device: per-scenario numbers
    as (S, 1), per-server arrays as (S, m), tier tables as (S, 1, T), so
    each broadcasts against (S, events) tensors.  ``laned=False`` reads an
    unlaned spec as one lane (S = 1)."""
    out = {}
    for k, v in spec.items():
        a = np.asarray(v, np.float64)
        if not laned:
            a = a[None]
        if a.ndim == 1:
            a = a[:, None]
        elif k.startswith("tier_"):
            a = a[:, None, :]
        out[k] = torch.as_tensor(a, device=device)
    return out


def pad_spec_cols(spec: dict, ncol: int) -> dict:
    """Pad the per-server spec arrays (``dt``, ``lam_j``, ``mu_j``) to a
    layout's column count by repeating the last server (padded columns are
    never gathered: every server index of a schedule is below m)."""
    out = dict(spec)
    for key in ("dt", "lam_j", "mu_j"):
        a = np.asarray(spec[key])
        w = ncol - a.shape[-1]
        if a.ndim and w > 0:
            out[key] = np.concatenate(
                [a, np.repeat(a[..., -1:], w, axis=-1)], axis=-1)
    return out


# The cost hooks take an unlaned spec (Python floats, (m,) arrays; the
# device CGM) or a lane spec (lane_spec_to_device): ``_price`` gathers the
# servers' prices per lane either way, and per lane from (S, n) events.
def _price(a, j):
    """Each event's price at its server: ``a[..., j]`` for (n,) server ids,
    lane by lane (``gather``) for (S, n) ones."""
    return a[..., j] if j.dim() == 1 else a.gather(-1, j)


def _transfer_hook(kind, spec, counts, sizes, j):
    if kind[0] == "table1":
        if kind[1]:  # paper_literal: Alg. 5 line 11 as written
            packed = spec["alpha"] * spec["mu"] * counts
        else:
            packed = (1.0 + (counts - 1.0) * spec["alpha"]) * spec["lam"]
        return torch.where(counts > 1, packed, counts * spec["lam"])
    if kind[0] == "tiered":
        v = sizes[..., None]
        seg = torch.clamp(
            torch.minimum(v, spec["tier_hi"]) - spec["tier_lo"], min=0.0)
        return _price(spec["lam_j"], j) * (seg * spec["tier_rates"]).sum(
            dim=-1)
    # heterogeneous
    disc = torch.where(
        counts > 1, (1.0 + (counts - 1.0) * spec["alpha"]) / counts, 1.0)
    return _price(spec["lam_j"], j) * sizes * disc


def _rate_hook(kind, spec, counts, sizes, j):
    if kind[0] == "table1":
        return counts * spec["mu"]
    return _price(spec["mu_j"], j) * sizes


# The replay step's event tensors are (n,), shared by the scenario lanes,
# or (S, n), each lane's own (lanes that each replay a schedule).
def _take(a, idx):
    """``a[:, idx]``: ``idx`` (n,) shared by the lanes, or (S, n) lane by
    lane; a 3-D ``a`` gives whole rows."""
    if idx.dim() == 1:
        return a[:, idx]
    if a.dim() == 3:
        idx = idx[..., None].expand(-1, -1, a.shape[2])
    return a.gather(1, idx)


def _put(a, idx, src) -> None:
    """``a[:, idx] = src`` in place, ``idx`` as :func:`_take` reads it."""
    if idx.dim() == 1:
        a[:, idx] = src
        return
    if a.dim() == 3:
        idx = idx[..., None].expand(-1, -1, a.shape[2])
    a.scatter_(1, idx, src.expand(idx.shape))


def _lane(a, idx):
    """``a[idx]`` for an event tensor ``a``: (n,) shared, or (S, n) with
    ``idx`` (S, k) lane by lane."""
    return a[idx] if a.dim() == 1 else a.gather(1, idx)


def fresh_state_arrays(n: int, m: int, layout=None) -> tuple:
    """Empty host state in the device layout: ``E`` (rows, cols) float64
    zeros and ``anchor`` (rows,) int64 -1, the last row being the dump row
    (dense: (n+1, m))."""
    rows, cols = StateLayout.resolve(layout).state_dims(n, m)
    return np.zeros((rows, cols), np.float64), np.full(rows, -1, np.int64)


def _state_arrays(state: CacheState, rows: int, cols: int, device) -> tuple:
    """Host ``CacheState`` -> (rows, cols) device arrays: the live (k, m)
    block in the top-left corner, padded rows inert, padded columns zero."""
    E0 = np.zeros((rows, cols), np.float64)
    a0 = np.full(rows, -1, np.int64)
    k = state.partition.k
    E0[:k, :state.m] = state.E
    a0[:k] = state.anchor
    return (torch.as_tensor(E0, device=device),
            torch.as_tensor(a0, device=device))


def state_to_device(state: CacheState, n: int, device, layout=None) -> tuple:
    """Host ``CacheState`` -> device arrays in ``layout``'s geometry: ``E``
    float64, ``anchor`` int64, the last row being the dump row (dense:
    (n+1, m))."""
    rows, cols = StateLayout.resolve(layout).state_dims(n, state.m)
    return _state_arrays(state, rows, cols, device)


def apply_acc(costs: CostBreakdown, schedule, acc: np.ndarray) -> CostBreakdown:
    """Fold the device accumulator + host counters into ``costs``."""
    costs.transfer += float(acc[0])
    costs.caching += float(acc[1])
    costs.keepalive_rent += float(acc[2])
    costs.n_misses += int(acc[3])
    costs.n_hits += int(acc[4])
    costs.items_transferred += int(acc[5])
    costs.n_requests += schedule.n_requests
    costs.n_item_requests += schedule.n_item_requests
    return costs


def _install_step(E, anchor, x, dt, now):
    """Partition-install state translation on the device (in place).

    Matched cliques that kept their index are untouched; matched cliques
    whose index moved are a compact row move (``inst_mov_*``); only the
    CHANGED cliques (``inst_chg_*``) pay the member-wise segment-min and
    the Alg.-1 seeding.  Every gather reads the pre-install state before
    the first write.  Padding rows point at the dump row K.  ``E`` (S,
    K+1, m), ``anchor`` (S, K+1) and ``dt`` (S, m) carry scenario lanes;
    an unlaned ``E`` (K+1, m) is one lane.  The install records are shared
    by the lanes with ``now`` a float, or each lane's own, (S, ...) with
    ``now`` an (S, 1) device tensor; a lane that installs nothing at this
    step holds the padding records, which write the dump row alone.
    """
    if E.dim() == 2:
        return _install_step(E[None], anchor[None], x, dt[None], now)
    S, _, m = E.shape
    ncr = x["inst_chg_rows"].shape[-1]
    movE = _take(E, x["inst_mov_src"])              # (S, nmv, m)
    movA = _take(anchor, x["inst_mov_src"])
    item_E = _take(E, x["inst_chg_src"])            # (S, nci, m)
    # segment_min over ncr segments: +inf where a segment is empty
    min_E = torch.full((S, ncr, m), float("inf"), dtype=E.dtype,
                       device=E.device)
    seg = x["inst_chg_seg"]
    seg = (seg[None] if seg.dim() == 1 else seg)[:, :, None].expand(S, -1, m)
    min_E.scatter_reduce_(1, seg, item_E, "amin", include_self=True)
    ok = x["inst_chg_ok"]
    now3 = now[..., None] if isinstance(now, torch.Tensor) else now
    fresh = torch.where(ok[..., None] & (min_E > now3), min_E, 0.0)
    row_max = fresh.max(dim=2).values               # (S, ncr)
    anew = torch.where(row_max > 0.0, fresh.argmax(dim=2), -1)
    need = ok & (row_max <= 0.0) & x["inst_seed_ok"]
    sj = x["inst_seed_j"]
    col = torch.arange(m, dtype=_I64, device=E.device)
    fresh = torch.where(need[:, :, None] & (col == sj[..., None]),
                        (now + _take(dt, sj))[:, :, None], fresh)
    anew = torch.where(need, sj, anew)
    _put(E, x["inst_mov_dst"], movE)
    _put(anchor, x["inst_mov_dst"], movA)
    _put(E, x["inst_chg_rows"], fresh)
    _put(anchor, x["inst_chg_rows"], anew)


def _scan_hook(use_kernels: bool):
    """The step's two scans: the kernel ``seg_scan_step``, or its plain
    version on the same device."""
    from ..kernels import segment_reduce as sr

    return sr.seg_scan_step if use_kernels else sr.seg_scan_step_plain


#: step tensors only the scans read: lanes with their own schedules hand
#: them to ``seg_scan_step`` as (G, L) rows, never gathered a lane
_SCAN_ONLY = ("t_s", "cj_t_s", "cj_j_s", "first_cjs")


def _replay_step(E, anchor, acc, x, spec, dt, dt0, *, kind, charge,
                 const_dt, scan_fn, capture=None, rows=None, xg=None,
                 record=None):
    """One step of the replay scan: Alg. 5/6 over the step's events, for
    every scenario lane at once.

    ``E`` (S, K+1, m) / ``anchor`` (S, K+1) / ``acc`` (S, 6) are updated
    in place; the step's event tensors ``x`` are (n,), shared by the
    lanes, or (S, n), each lane's own: then ``xg`` holds the step's (G, n)
    rows and ``rows`` (S,) each lane's, and the scans read their inputs
    from ``xg`` through ``rows``.  ``spec`` is in lane form
    (:func:`lane_spec_to_device`), ``dt`` (S, m) and ``dt0`` its first
    column (S, 1), a device tensor (a Python float divisor would make CUDA
    multiply by its reciprocal).  Each f64 operation is its own PyTorch
    op, so it rounds once, as numpy does: the state is float for float the
    numpy engine's.  ``capture`` (a dict) receives the scans' inputs:
    ``seg_scan_step``'s, and each scan's operand formed by PyTorch ops for
    the standalone kernels.  ``record`` (S, 3), when given, receives the
    step's transfer, its caching charge on missed events and its missed
    items (``n_req`` of the missed events), lane by lane.
    """
    S, K1, m = E.shape
    K = K1 - 1
    Ef = E.view(S, K1 * m)                          # flat (clique, server)
    cl, j, t, val = x["ev_c"], x["ev_j"], x["ev_t"], x["val"]
    dt_e = dt0 if const_dt else _take(dt, j)
    E_before = torch.where(x["first_cj"], _take(Ef, cl * m + j),
                           x["prev_cj_t"] + dt_e)   # (S, ne)

    # --- anchor resolution ------------------------------------------------
    if const_dt:
        a0 = _take(anchor, cl)
        anchor_alive = torch.where(
            x["first_c"], (a0 == j) & (E_before > 0.0), x["prev_j"] == j)
    else:
        first_cs, c_s, j_s = x["first_cs"], x["c_s"], x["j_s"]
        src = x if rows is None else xg
        scan_in = (src["t_s"], src["j_s"], src["first_cs"], src["cj_t_s"],
                   src["cj_j_s"], src["first_cjs"], dt)
        if rows is not None:
            scan_in += (rows,)
        if capture is not None:
            capture["seg_scan_step"] = tuple(a.clone() for a in scan_in)
            t_l, cj_t, cj_j, first_cjs = (
                (src[k] if rows is None else src[k][rows]) for k in
                ("t_s", "cj_t_s", "cj_j_s", "first_cjs"))
            capture["seg_running_argmax"] = (t_l + _take(dt, j_s),
                                             first_cs.clone())
            capture["seg_running_max"] = (cj_t + _take(dt, cj_j),
                                          first_cjs.clone())
        v, bidx, vmax = scan_fn(*scan_in)           # per lane
        a0_s = _take(anchor, c_s)
        Eg = Ef.gather(1, c_s * m + a0_s.clamp(min=0))   # in-range gather
        Ea0_s = torch.where(a0_s >= 0, Eg, float("-inf"))
        prev_v = torch.where(
            first_cs, float("-inf"),
            torch.cat([v.new_full((S, 1), float("-inf")), v[:, :-1]], dim=1))
        prev_b = torch.where(
            first_cs, 0, torch.cat([bidx.new_zeros((S, 1)), bidx[:, :-1]],
                                   dim=1))
        inbatch = ~first_cs & (prev_v >= Ea0_s)
        anchor_seen_s = torch.where(inbatch, _lane(j_s, prev_b), a0_s)
        anchor_seen = _take(anchor_seen_s, x["inv_o_c"])  # un-sort
        anchor_alive = (anchor_seen == j) & (E_before > 0.0)

    fresh = E_before > t
    nokeep = x.get("nokeep")
    if nokeep is not None:
        # keep-or-not (TTL) cliques: forced miss, and their state writes
        # go to the dump row, so lag chains must not fabricate hits
        fresh = fresh & ~nokeep
        anchor_alive = anchor_alive & ~nokeep
    alive = fresh | anchor_alive
    miss = ~alive & val
    lapsed = alive & ~fresh & val

    # Alg. 6 ratcheting of lapsed anchor copies
    steps = torch.ceil((t - E_before) / dt_e)
    r = E_before + steps * dt_e
    r = torch.where(r <= t, r + dt_e, r)
    e_eff = torch.where(fresh, E_before, torch.where(lapsed, r, t))

    # --- costs (the cost model's batched hooks, priced per lane) ----------
    size = x["size"]
    csize = x["csize"] if "csize" in x else size
    rate_stored = _rate_hook(kind, spec, size, csize, j)
    rent = torch.where(lapsed, rate_stored * (e_eff - E_before), 0.0)
    tc = torch.where(miss, _transfer_hook(kind, spec, size, csize, j), 0.0)
    if charge == "requested":
        rate = _rate_hook(kind, spec, x["n_req"],
                          x["req_size"] if "req_size" in x else x["n_req"], j)
    else:
        rate = rate_stored
    dur = torch.clamp((t + dt_e) - torch.maximum(e_eff, t), min=0.0)
    cval = (val & ~nokeep) if nokeep is not None else val
    cc = torch.where(cval, rate * dur, 0.0)
    nm = miss.sum(dim=1)
    acc += torch.stack([
        tc.sum(dim=1), cc.sum(dim=1), rent.sum(dim=1),
        nm.to(torch.float64), (val.sum(dim=-1) - nm).to(torch.float64),
        torch.where(miss, size, 0.0).sum(dim=1),
    ], dim=1)
    if record is not None:
        record.copy_(torch.stack([
            tc.sum(dim=1), torch.where(miss, cc, 0.0).sum(dim=1),
            torch.where(miss, x["n_req"], 0.0).sum(dim=1)], dim=1))

    # --- state update on the compacted segment-last arrays ----------------
    uc, uj, ac = x["upd_c"], x["upd_j"], x["anc_c"]
    if const_dt:
        _put(Ef, uc * m + uj, x["upd_t"] + dt0)
        a_cur = _take(anchor, ac)
        aE = Ef.gather(1, ac * m + a_cur.clamp(min=0))   # POST-update E
        upd = (a_cur < 0) | (x["anc_t"] + dt0 >= aE)
        anchor.scatter_(1, torch.where(upd, ac, K),
                        x["anc_j"].expand(S, -1))
    else:
        _put(Ef, uc * m + uj, _take(vmax, x["pos_u"]))
        pa = x["pos_a"]
        win = _take(v, pa) >= _take(Ea0_s, pa)
        _put(anchor, ac, torch.where(win, _lane(j_s, _take(bidx, pa)),
                                     _take(a0_s, pa)))


def schedule_to_device(schedule, device) -> dict:
    """The schedule's step tensors on ``device``, in one upload per key;
    int32 index arrays become int64."""
    out = {}
    for key, a in schedule.xs.items():
        a = np.asarray(a)
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        out[key] = torch.as_tensor(a).to(device)
    return out


def schedules_to_device(schedules, device) -> dict:
    """G schedules' step tensors on ``device`` as (nb, G, ...) tensors, in
    one upload per key: a step's G rows are one contiguous block, as
    ``seg_scan_step`` reads them; int32 index arrays become int64."""
    out = {}
    for key in schedules[0].xs:
        a = np.stack([np.asarray(s.xs[key]) for s in schedules], axis=1)
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        out[key] = torch.as_tensor(a).to(device)
    return out


def _nbytes(xs: dict) -> int:
    """Bytes of the step tensors on the device."""
    return sum(v.numel() * v.element_size() for v in xs.values())


def _check_server_ids(schedule, m: int, name: str) -> None:
    """Under per-server dt the scans' server ids must lie in [0, m): the
    kernel prices any other as NaN, the plain chain raises or wraps."""
    for key in () if schedule.const_dt else ("j_s", "cj_j_s"):
        ids = np.asarray(schedule.xs[key])
        if ids.size and (ids.min() < 0 or ids.max() >= m):
            raise ValueError(f"{name}: {key} holds server ids outside "
                             f"[0, {m}): [{ids.min()}, {ids.max()}]")


def _scan(E3, A2, acc2, xs, live, inst, spec_d, statics, *, charge,
          const_dt, scan_fn, check, capture_at, rows=None, gather=True,
          now=None, record=None) -> dict:
    """The replay scan's loop over the ``live`` steps: a Python loop that
    branches on host flags only, so it makes no device sync
    (``check=True`` makes any sync raise).  Shared steps (``rows`` None)
    take each install's ``now`` from the host array ``now``; with ``rows``
    the step tensors are (nb, G, ...), each lane reads its row, and
    ``now`` comes from the device (``gather=False``: the rows are the
    lanes already, in order).  Returns the scan inputs captured at step
    ``capture_at``."""
    dt = spec_d["dt"]                               # (S, m)
    dt0 = dt[:, :1]
    seen: dict = {}
    if check:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        for b in live:
            xg = {k: v[b] for k, v in xs.items()}
            if rows is None:
                x, now_b = xg, None
            else:
                x = {k: v.index_select(0, rows) for k, v in xg.items()
                     if k not in _SCAN_ONLY} if gather else xg
                now_b = x["inst_now"][:, None]
            if inst[b]:
                _install_step(E3, A2, x, dt,
                              float(now[b]) if rows is None else now_b)
            _replay_step(E3, A2, acc2, x, spec_d, dt, dt0, kind=statics,
                         charge=charge, const_dt=const_dt, scan_fn=scan_fn,
                         capture=seen if b == capture_at else None,
                         rows=rows, xg=xg,
                         record=None if record is None else record[b])
    finally:
        if check:
            torch.cuda.set_sync_debug_mode(mode)
    return seen


def run_schedule(schedule, spec: dict, statics: tuple, E: torch.Tensor,
                 anchor: torch.Tensor, *, charge="requested",
                 use_kernels: bool = True, stats: dict | None = None,
                 check_syncs: bool = False, xs: dict | None = None,
                 acc: torch.Tensor | None = None,
                 record: torch.Tensor | None = None):
    """Execute one schedule on the device of ``E``; returns
    ``(E, anchor, acc)``, all on that device (``E`` and ``anchor`` are
    updated in place).

    A caller that keeps the state on the device across schedules (the live
    server) passes what it holds there already: ``spec`` in lane form as
    :func:`lane_spec_to_device` returns it (a dict of tensors), ``xs`` the
    step tensors as :func:`schedule_to_device` returns them, and ``acc``,
    the (6,) or (S, 6) float64 accumulator to add this schedule's costs
    into, in place.  Otherwise the spec and steps go up here and ``acc``
    starts at zero.

    ``E`` (n+1, m) / ``anchor`` (n+1,) with an unlaned ``spec`` give
    ``acc`` (6,).  With a leading axis of S scenario lanes, ``E`` (S, n+1,
    m), ``anchor`` (S, n+1) and every spec entry with a leading S (numbers
    (S,), per-server arrays (S, m)), the schedule's event tensors are
    shared by the lanes and ``acc`` is (S, 6): lane s equals an unlaned
    run under spec lane s.

    The step tensors go up once, before the loop.  Steps with neither
    events nor an install are skipped (the schedule pads its step count to
    a bucket; such steps write only the dump row).  ``stats`` receives
    the step and install counts.  With capture on
    (:mod:`repro_torch.kernels.capture`), the widest step's scan inputs
    are kept.  Under per-server dt the scans' server ids are checked
    against ``m`` on the host, once, before the upload.  ``check_syncs=
    True`` on a CUDA device makes any operation of the loop that would
    synchronise with the host raise (``torch.cuda.set_sync_debug_mode``):
    the loop is meant to make none.  ``record``, an (nb, S, 3) float64
    tensor on the device (S = 1 unlaned), receives each live step's
    transfer, caching charge on missed events and missed items, lane by
    lane (:func:`_replay_step`); it is written in the loop and read by the
    caller, once, after it.
    """
    from ..kernels import capture

    dev = E.device
    laned = E.dim() == 3
    if not (E.is_contiguous() and anchor.is_contiguous()):
        raise ValueError("run_schedule needs a contiguous E and anchor")
    E3, A2 = (E, anchor) if laned else (E[None], anchor[None])
    S = E3.shape[0]
    spec_d = (spec if isinstance(spec["dt"], torch.Tensor)
              else lane_spec_to_device(spec, dev, laned))
    _check_server_ids(schedule, int(spec_d["dt"].shape[1]), "run_schedule")
    if xs is None:
        xs = schedule_to_device(schedule, dev)
    inst = np.asarray(schedule.xs["inst"])
    n_ev = np.asarray(schedule.xs["val"]).sum(axis=1)
    live = np.nonzero((n_ev > 0) | inst)[0].tolist()
    widest = int(np.argmax(n_ev)) if capture.INPUTS is not None else -1
    if acc is None:
        acc = torch.zeros(((S, N_ACC) if laned else N_ACC),
                          dtype=torch.float64, device=dev)
    seen = _scan(E3, A2, acc if laned else acc[None], xs, live, inst,
                 spec_d, statics, charge=charge, const_dt=schedule.const_dt,
                 scan_fn=_scan_hook(use_kernels),
                 check=check_syncs and dev.type == "cuda", capture_at=widest,
                 now=np.asarray(schedule.xs["inst_now"]), record=record)
    for name, inputs in seen.items():
        capture.keep_largest(name, S * int(n_ev[widest]), lambda: inputs)
    if stats is not None:
        stats.update(steps=len(live), installs=int(inst[live].sum()),
                     sync_scan=0, lanes=S, xs_bytes=_nbytes(xs))
    return E, anchor, acc


def run_schedules(schedules, spec: dict, statics: tuple, E: torch.Tensor,
                  anchor: torch.Tensor, *, rows=None, charge="requested",
                  use_kernels: bool = True, stats: dict | None = None,
                  check_syncs: bool = False,
                  record: torch.Tensor | None = None):
    """Execute lanes that each replay a schedule of their own, in one scan:
    the counterpart of ``engine_jax.run_schedules`` (the trace-shard axis
    and the cohorts of the sweep).  Returns ``(E, anchor, acc)`` as the
    laned :func:`run_schedule` does.

    ``schedules`` are the G DISTINCT schedules, each uploaded once: their
    step tensors go up as (nb, G, ...) and ``rows`` (S,) names the
    schedule of each lane (None: lane i replays ``schedules[i]``).  A lane
    is never a copy of a schedule.  ``spec`` / ``E`` / ``anchor`` carry the
    leading S axis.  The schedules must share padded dims
    (:func:`~repro_torch.core.schedule.pad_schedule`), state geometry
    (``state_rows`` / ``state_cols``: under a bucketed layout, schedules of
    different (n, m) in one bucket), ``const_dt`` and their set of step
    tensors.

    The loop runs the union of the lanes' live steps.  A lane with no
    events at a step runs padding events, and a lane with no install at an
    install step the padding records: both write the dump row alone, so
    lane s equals an unlaned :func:`run_schedule` of its schedule under
    spec lane s, the dump row aside.  Each install's ``now`` comes from
    the device, a lane's own.  Under per-server dt each step's two scans
    are one ``seg_scan_step`` launch over the (G, L) rows.  ``rows`` is
    checked against [0, G) and every schedule's server ids against ``m``
    on the host, once.  One distinct schedule (G = 1) is
    :func:`run_schedule`'s shared form.  ``stats``, ``check_syncs`` and
    ``record`` as :func:`run_schedule` takes them.
    """
    from ..kernels import capture
    from .schedule import schedule_dims

    G = len(schedules)
    rows = np.arange(G) if rows is None else np.asarray(rows, np.int64)
    S = int(rows.shape[0])
    if E.dim() != 3 or E.shape[0] != S or tuple(anchor.shape[:1]) != (S,):
        raise ValueError(f"run_schedules needs E (S, rows, cols) and anchor "
                         f"(S, rows) for {S} lanes, got {tuple(E.shape)} "
                         f"and {tuple(anchor.shape)}")
    if G == 0 or rows.ndim != 1 or (S and (rows.min() < 0
                                           or rows.max() >= G)):
        raise ValueError(f"run_schedules: lane rows must lie in [0, {G}), "
                         f"got {rows.tolist()}")
    s0 = schedules[0]
    geom = (s0.state_rows, s0.state_cols)
    for s in schedules[1:]:
        if (s.const_dt != s0.const_dt
                or (s.state_rows, s.state_cols) != geom
                or schedule_dims(s) != schedule_dims(s0)
                or set(s.xs) != set(s0.xs)):
            raise ValueError(
                "run_schedules needs schedules of one state geometry, "
                "const_dt, padded dims and step-tensor set (pad_schedule)")
    if G == 1:
        return run_schedule(s0, spec, statics, E, anchor, charge=charge,
                            use_kernels=use_kernels, stats=stats,
                            check_syncs=check_syncs, record=record)
    dev = E.device
    if not (E.is_contiguous() and anchor.is_contiguous()):
        raise ValueError("run_schedules needs a contiguous E and anchor")
    spec_d = (spec if isinstance(spec["dt"], torch.Tensor)
              else lane_spec_to_device(spec, dev, True))
    for s in schedules:
        _check_server_ids(s, int(spec_d["dt"].shape[1]), "run_schedules")
    xs = schedules_to_device(schedules, dev)
    rows_d = torch.as_tensor(rows, dtype=_I64, device=dev)
    inst = np.stack([np.asarray(s.xs["inst"]) for s in schedules])
    n_ev = np.stack([np.asarray(s.xs["val"]).sum(axis=1)
                     for s in schedules])               # (G, nb)
    live = np.nonzero(((n_ev > 0) | inst).any(axis=0))[0].tolist()
    widest = (int(np.argmax(n_ev.max(axis=0)))
              if capture.INPUTS is not None else -1)
    acc = torch.zeros((S, N_ACC), dtype=torch.float64, device=dev)
    seen = _scan(E, anchor, acc, xs, live, inst.any(axis=0), spec_d,
                 statics, charge=charge, const_dt=s0.const_dt,
                 scan_fn=_scan_hook(use_kernels),
                 check=check_syncs and dev.type == "cuda",
                 capture_at=widest, rows=rows_d,
                 gather=not np.array_equal(rows, np.arange(G)), record=record)
    for name, inputs in seen.items():
        capture.keep_largest(name, S * int(n_ev[:, widest].max()),
                             lambda: inputs)
    if stats is not None:
        stats.update(steps=len(live),
                     installs=int(inst.any(axis=0)[live].sum()),
                     sync_scan=0, lanes=S, schedules=G,
                     xs_bytes=_nbytes(xs))
    return E, anchor, acc


def build_host_schedule(partition0, trace, clique_generator, t_cg, *,
                        model, env, lookup, batch_size=None,
                        seed_new_cliques: bool = True, layout=None,
                        use_kernels: bool = True, next_cg0=None,
                        win_prefix=None, progress=None) -> tuple:
    """One host schedule: clique generation on the host every ``t_cg`` by
    ``clique_generator`` (a policy's ``on_window``, its CRM hooks wired to
    the lookup's device), items -> cliques through ``lookup`` (a
    :class:`~repro_torch.kernels.packed_lookup.CliqueLookup`).  Returns
    ``(schedule, stats)``: the build's seconds, the clique generation's
    and the lookups'."""
    from .schedule import build_schedule

    pol = getattr(clique_generator, "__self__", None)
    wire = getattr(pol, "wire_kernels", None)
    if t_cg is not None and wire is not None:
        wire(lookup.device, use_kernels)
    t0 = time.perf_counter()
    cg0 = getattr(pol, "cg_seconds", 0.0)
    lookup.use_kernel = use_kernels
    look0 = lookup.stats()
    with _span("host.schedule"):
        schedule = build_schedule(
            partition0, trace, clique_generator, t_cg, model=model, env=env,
            batch_size=batch_size, seed_new_cliques=seed_new_cliques,
            next_cg0=next_cg0, win_prefix=win_prefix, lookup=lookup,
            progress=progress, layout=layout)
    wall = time.perf_counter() - t0
    look = {key: v - look0[key] for key, v in lookup.stats().items()}
    cg_s = getattr(pol, "cg_seconds", 0.0) - cg0
    return schedule, dict(schedule_s=wall, cg_s=cg_s, **look,
                          schedule_rest_s=wall - cg_s - look["lookup_s"])


def replay_lanes(schedule, specs: list, statics: tuple, costs: list, *,
                 device, state: CacheState | None = None, rows=None,
                 charge="requested", use_kernels: bool = True,
                 record: bool = False) -> tuple:
    """Replay under each pricing spec of ``specs``, the lanes of one scan,
    every lane starting from ``state`` (a fresh state when None), in the
    schedules' state geometry (their ``state_rows`` x ``state_cols``).
    ``schedule`` is the one schedule every lane replays (a laned
    :func:`run_schedule`), or a list of distinct schedules with ``rows``
    naming each lane's (:func:`run_schedules`).  Lane s's accumulator is
    folded into ``costs[s]``.  Returns ``(states, stats)``: the lanes'
    final :class:`~repro_torch.core.engine.CacheState` and the scan's
    step counts and seconds; with ``record=True`` also ``stats["record"]``,
    the (nb, S, 3) per-step record (:func:`run_schedule`) on the host."""
    t0 = time.perf_counter()
    S = len(specs)
    scheds = list(schedule) if isinstance(schedule, (list, tuple)) \
        else [schedule]
    rows = np.zeros(S, np.int64) if rows is None else np.asarray(rows)
    s0 = scheds[0]
    if state is None:
        state = CacheState.fresh(s0.partition0, s0.m)
    stats: dict = {}
    with _span("host.scan"):
        E0, a0 = _state_arrays(state, s0.state_rows, s0.state_cols, device)
        spec = {k: np.stack([sp[k] for sp in specs]) for k in specs[0]}
        rec = (torch.zeros((s0.nb, S, 3), dtype=torch.float64, device=device)
               if record else None)
        E0 = E0.expand(S, -1, -1).contiguous()
        a0 = a0.expand(S, -1).contiguous()
        if len(scheds) == 1:
            E, anchor, acc = run_schedule(
                s0, spec, statics, E0, a0, charge=charge,
                use_kernels=use_kernels, stats=stats, record=rec)
        else:
            E, anchor, acc = run_schedules(
                scheds, spec, statics, E0, a0, rows=rows, charge=charge,
                use_kernels=use_kernels, stats=stats, record=rec)
        acc = acc.cpu().numpy()
        kmax = max(sc.final_partition.k for sc in scheds)
        E = E[:, :kmax].cpu().numpy()
        anchor = anchor[:, :kmax].cpu().numpy()
        if record:
            stats["record"] = rec.cpu().numpy()
    states = []
    for lane, c in enumerate(costs):
        sched = scheds[rows[lane]]
        apply_acc(c, sched, acc[lane])
        part = sched.final_partition
        states.append(CacheState.from_device(
            part, E[lane, :part.k], anchor[lane, :part.k], sched.m))
    stats["scan_s"] = time.perf_counter() - t0
    return states, stats


class TorchReplayEngine:
    """The device replay driver (counterpart of ``JaxReplayEngine``).

    Wraps (or builds) a :class:`~repro_torch.core.engine.ReplayEngine` that
    holds configuration, cache state and costs; ``replay`` runs the trace
    on ``device`` and syncs state + costs back, so the host state after a
    replay equals what the numpy engine of ``repro`` produces.  ``layout``
    sets the host-schedule replay's state geometry (dense or bucketed: the
    per-server spec arrays pad to its columns); the device clique
    generation keeps a dense-n carry of its own under either.
    """

    def __init__(self, *args, engine: ReplayEngine | None = None,
                 device=None, layout: StateLayout | str | None = None,
                 **kwargs):
        from ..kernels.packed_lookup import CliqueLookup

        self.device = resolve_device(device)
        self.layout = StateLayout.resolve(layout)
        self.engine = engine if engine is not None else ReplayEngine(
            *args, **kwargs)
        self._spec, self._statics = cost_spec(
            self.engine.model, self.engine.env)
        #: the spec at the layout's columns (the host-schedule replay's;
        #: padded columns repeat the last server and are never gathered)
        ncol = self.layout.state_cols(self.engine.env.m)
        self._state_spec = (self._spec if ncol == self.engine.env.m
                            else pad_spec_cols(self._spec, ncol))
        #: the host schedule's item -> clique lookup on this device
        self.lookup = CliqueLookup(self.device)
        self.last_schedule = None
        self.last_stats: dict = {}
        #: the last ``replay(record=True)``'s per-step record
        self.last_record = None

    @property
    def state(self) -> CacheState:
        return self.engine.state

    @property
    def costs(self) -> CostBreakdown:
        return self.engine.costs

    def install_partition(self, *a, **k) -> None:
        self.engine.install_partition(*a, **k)

    def replay(self, trace, clique_generator=None, t_cg=None,
               batch_size=None, *, progress=None, next_cg0=None,
               win_prefix=None, use_kernels: bool = True,
               record: bool = False) -> CostBreakdown:
        """Replay ``trace`` on the device, with clique generation every
        ``t_cg`` by ``clique_generator`` (a policy's ``on_window``).

        An AKPC policy the device clique generation admits runs it on the
        device; everything else takes the host-schedule replay.
        ``use_kernels=False`` runs the plain versions in place of the
        kernels on the same device (the comparison run).  ``record=True``
        (host-schedule replay) keeps each step's transfer, caching charge
        on missed events and missed items in ``last_record`` ((nb, 3),
        host numpy; at ``batch_size=1`` with no clique generation, step i
        is request i).
        """
        from .cgm import replay_cgm
        from .cgm_schedule import wants_device_cgm
        from .schedule import pad_schedule, schedule_dims

        eng = self.engine
        keep_fn = None
        if clique_generator is not None and t_cg is not None:
            pol = getattr(clique_generator, "__self__", None)
            keep_fn = getattr(pol, "item_keep", None)
            if pol is not None and not record and wants_device_cgm(
                    pol, trace, eng.model) and \
                    self.layout.supports_device_cgm(eng.env.n, eng.env.m):
                return replay_cgm(
                    self, pol, trace, t_cg=t_cg, batch_size=batch_size,
                    next_cg0=next_cg0, win_prefix=win_prefix,
                    use_kernels=use_kernels)
        schedule, stats = build_host_schedule(
            eng.state.partition, trace, clique_generator, t_cg,
            model=eng.model, env=eng.env, lookup=self.lookup,
            batch_size=batch_size, seed_new_cliques=eng.seed_new_cliques,
            layout=self.layout, use_kernels=use_kernels, next_cg0=next_cg0,
            win_prefix=win_prefix, progress=progress)
        # shape ratchet: pad every chunk's tensors up to the largest dims
        # this engine has seen, as the reference does for its compiles
        dims = schedule_dims(schedule)
        prev = getattr(self, "_dims", None)
        if prev is not None:
            dims = {k: max(dims[k], prev[k]) for k in dims}
        self._dims = dims
        schedule = pad_schedule(schedule, dims)
        self.last_schedule = schedule
        (eng.state,), scan = replay_lanes(
            schedule, [self._state_spec], self._statics, [eng.costs],
            device=self.device, state=eng.state, charge=eng.caching_charge,
            use_kernels=use_kernels, record=record)
        if record:
            self.last_record = scan.pop("record")[:, 0]
        eng._set_partition_caches(schedule.final_partition)
        if keep_fn is not None:
            # boundary evictions already ran on the device; this only
            # aligns the host engine's mask
            eng.set_item_keep(keep_fn())
        stats.update(path="host_schedule", nb=schedule.nb, ne=schedule.ne,
                     const_dt=schedule.const_dt, sync_final=3, **scan)
        self.last_stats = stats
        return eng.costs


def run_policy_torch(policy, trace, *, device=None, batch_size=None,
                     progress=None, use_kernels: bool = True, layout=None):
    """Offline driver on the device: the counterpart of ``run_policy_jax``.

    Binds the policy, resolves the environment, installs an offline
    policy's initial partition, replays the trace in T_CG windows (clique
    generation only when the policy has a ``t_cg``), and returns a
    :class:`~repro_torch.core.policy.RunResult`.  ``layout`` is the device
    state layout (:class:`~repro_torch.core.state_layout.StateLayout`, a
    kind string, or None for dense).
    """
    from .policy import RunResult, get_policy

    if isinstance(policy, str):
        policy = get_policy(policy)
    t0 = time.perf_counter()
    policy.bind(trace.n, trace.m)
    env = CacheEnvironment.resolve(
        getattr(policy, "env", None), trace, policy.params)
    eng = TorchReplayEngine(
        trace.n,
        trace.m,
        policy.params,
        caching_charge=getattr(policy, "caching_charge", "requested"),
        seed_new_cliques=getattr(policy, "seed_new_cliques", True),
        env=env,
        cost_model=getattr(policy, "cost_model", "table1"),
        device=device,
        layout=layout,
    )
    part0 = policy.initial_partition(trace)
    if part0 is not None:
        eng.install_partition(part0, now=0.0)
    gen = policy.on_window if policy.t_cg is not None else None
    bs = batch_size if batch_size is not None else policy.batch_size
    eng.replay(trace, clique_generator=gen, t_cg=policy.t_cg,
               batch_size=bs, progress=progress, use_kernels=use_kernels)
    return RunResult(
        policy=policy.name,
        costs=eng.costs,
        clique_sizes=eng.state.partition.sizes(),
        size_history=list(policy.size_history),
        n_windows=policy.n_windows,
        cg_seconds=policy.cg_seconds,
        wall_seconds=time.perf_counter() - t0,
        config=policy.config,
        state=eng.state,
        loop_stats=dict(eng.last_stats),
    )
