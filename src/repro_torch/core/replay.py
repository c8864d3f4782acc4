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
  the kernels ``seg_running_argmax`` and ``seg_running_max``;
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


def _transfer_hook(kind, spec, counts, sizes, j):
    if kind[0] == "table1":
        if kind[1]:  # paper_literal: Alg. 5 line 11 as written
            packed = spec["alpha"] * spec["mu"] * counts
        else:
            packed = (1.0 + (counts - 1.0) * spec["alpha"]) * spec["lam"]
        return torch.where(counts > 1, packed, counts * spec["lam"])
    if kind[0] == "tiered":
        v = sizes[:, None]
        seg = torch.clamp(
            torch.minimum(v, spec["tier_hi"]) - spec["tier_lo"], min=0.0)
        return spec["lam_j"][j] * (seg * spec["tier_rates"]).sum(dim=-1)
    # heterogeneous
    disc = torch.where(
        counts > 1, (1.0 + (counts - 1.0) * spec["alpha"]) / counts, 1.0)
    return spec["lam_j"][j] * sizes * disc


def _rate_hook(kind, spec, counts, sizes, j):
    if kind[0] == "table1":
        return counts * spec["mu"]
    return spec["mu_j"][j] * sizes


def state_to_device(state: CacheState, n: int, device) -> tuple:
    """Host ``CacheState`` -> dense device arrays: ``E`` (n+1, m) float64,
    ``anchor`` (n+1,) int64, the last row being the dump row."""
    rows, cols = StateLayout.resolve(None).state_dims(n, state.m)
    E0 = np.zeros((rows, cols), np.float64)
    a0 = np.full(rows, -1, np.int64)
    k = state.partition.k
    E0[:k] = state.E
    a0[:k] = state.anchor
    return (torch.as_tensor(E0, device=device),
            torch.as_tensor(a0, device=device))


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


def _install_step(E, anchor, x, dt, now: float):
    """Partition-install state translation on the device (in place).

    Matched cliques that kept their index are untouched; matched cliques
    whose index moved are a compact row move (``inst_mov_*``); only the
    CHANGED cliques (``inst_chg_*``) pay the member-wise segment-min and
    the Alg.-1 seeding.  Every gather reads the pre-install state before
    the first write.  Padding rows point at the dump row K.
    """
    ncr = x["inst_chg_rows"].shape[0]
    m = E.shape[1]
    movE = E[x["inst_mov_src"]]                     # (nmv, m)
    movA = anchor[x["inst_mov_src"]]
    item_E = E[x["inst_chg_src"]]                   # (nci, m)
    # segment_min over ncr segments: +inf where a segment is empty
    min_E = torch.full((ncr, m), float("inf"), dtype=E.dtype,
                       device=E.device)
    seg = x["inst_chg_seg"][:, None].expand(-1, m)
    min_E.scatter_reduce_(0, seg, item_E, "amin", include_self=True)
    ok = x["inst_chg_ok"]
    fresh = torch.where(ok[:, None] & (min_E > now), min_E, 0.0)
    row_max = fresh.max(dim=1).values
    anew = torch.where(row_max > 0.0, fresh.argmax(dim=1), -1)
    need = ok & (row_max <= 0.0) & x["inst_seed_ok"]
    sj = x["inst_seed_j"]
    col = torch.arange(m, dtype=_I64, device=E.device)
    fresh = torch.where(need[:, None] & (col[None, :] == sj[:, None]),
                        (now + dt[sj])[:, None], fresh)
    anew = torch.where(need, sj, anew)
    E[x["inst_mov_dst"]] = movE
    anchor[x["inst_mov_dst"]] = movA
    E[x["inst_chg_rows"]] = fresh
    anchor[x["inst_chg_rows"]] = anew


def _seg_hooks(use_kernels: bool):
    """(seg_running_max, seg_running_argmax): the kernels, or their plain
    versions on the same device."""
    from ..kernels import segment_reduce as sr

    if use_kernels:
        return sr.seg_running_max, sr.seg_running_argmax
    return sr.seg_running_max_plain, sr.seg_running_argmax_plain


def _replay_step(E, anchor, acc, x, spec, dt, dt0, *, kind, charge,
                 const_dt, seg_max_fn, seg_argmax_fn, capture=None):
    """One step of the replay scan: Alg. 5/6 over the step's events.

    ``E`` / ``anchor`` / ``acc`` are updated in place.  ``dt0`` is
    ``dt[0]`` as a device scalar (a Python float divisor would make CUDA
    multiply by its reciprocal).  Each f64 operation is its own PyTorch
    op, so it rounds once, as numpy does: the state is float for float the
    numpy engine's.  ``capture`` (a dict) receives the scans' inputs.
    """
    K = E.shape[0] - 1
    cl, j, t, val = x["ev_c"], x["ev_j"], x["ev_t"], x["val"]
    dt_e = dt0 if const_dt else dt[j]
    E_before = torch.where(x["first_cj"], E[cl, j], x["prev_cj_t"] + dt_e)

    # --- anchor resolution ------------------------------------------------
    if const_dt:
        a0 = anchor[cl]
        anchor_alive = torch.where(
            x["first_c"], (a0 == j) & (E_before > 0.0), x["prev_j"] == j)
    else:
        first_cs = x["first_cs"]
        e_val_s = x["t_s"] + dt[x["j_s"]]
        if capture is not None:
            capture["seg_running_argmax"] = (e_val_s.clone(), first_cs.clone())
        v, bidx = seg_argmax_fn(e_val_s, first_cs)
        bidx = bidx.to(_I64)
        a0_s = anchor[x["c_s"]]
        Eg = E[x["c_s"], a0_s.clamp(min=0)]         # in-range gather
        Ea0_s = torch.where(a0_s >= 0, Eg, float("-inf"))
        prev_v = torch.where(
            first_cs, float("-inf"),
            torch.cat([v.new_full((1,), float("-inf")), v[:-1]]))
        prev_b = torch.where(
            first_cs, 0, torch.cat([bidx.new_zeros(1), bidx[:-1]]))
        inbatch = ~first_cs & (prev_v >= Ea0_s)
        anchor_seen_s = torch.where(inbatch, x["j_s"][prev_b], a0_s)
        anchor_seen = anchor_seen_s[x["inv_o_c"]]   # un-sort by gather
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

    # --- costs (the cost model's batched hooks) ---------------------------
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
    nm = miss.sum()
    acc += torch.stack([
        tc.sum(), cc.sum(), rent.sum(),
        nm.to(torch.float64), (val.sum() - nm).to(torch.float64),
        torch.where(miss, size, 0.0).sum(),
    ])

    # --- state update on the compacted segment-last arrays ----------------
    uc, uj, ac = x["upd_c"], x["upd_j"], x["anc_c"]
    if const_dt:
        E[uc, uj] = x["upd_t"] + dt0
        a_cur = anchor[ac]
        aE = E[ac, a_cur.clamp(min=0)]              # POST-update E
        upd = (a_cur < 0) | (x["anc_t"] + dt0 >= aE)
        anchor[torch.where(upd, ac, K)] = x["anc_j"]
    else:
        e_cj_s = x["cj_t_s"] + dt[x["cj_j_s"]]
        if capture is not None:
            capture["seg_running_max"] = (e_cj_s.clone(),
                                          x["first_cjs"].clone())
        vmax = seg_max_fn(e_cj_s, x["first_cjs"])
        E[uc, uj] = vmax[x["pos_u"]]
        pa = x["pos_a"]
        win = v[pa] >= Ea0_s[pa]
        anchor[ac] = torch.where(win, x["j_s"][bidx[pa]], a0_s[pa])


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


def run_schedule(schedule, spec: dict, statics: tuple, E: torch.Tensor,
                 anchor: torch.Tensor, *, charge="requested",
                 use_kernels: bool = True, stats: dict | None = None,
                 check_syncs: bool = False):
    """Execute one schedule on the device of ``E``; returns
    ``(E, anchor, acc)``, all on that device (``E`` and ``anchor`` are
    updated in place).

    The step tensors go up once, before the loop.  Steps with neither
    events nor an install are skipped (the schedule pads its step count to
    a bucket; such steps write only the dump row).  ``stats`` receives
    the step and install counts.  With capture on
    (:mod:`repro_torch.kernels.capture`), the widest step's scan inputs
    are kept.  ``check_syncs=True`` on a CUDA device makes any operation
    of the loop that would synchronise with the host raise
    (``torch.cuda.set_sync_debug_mode``): the loop is meant to make none.
    """
    from ..kernels import capture

    dev = E.device
    spec_d = spec_to_device(spec, dev)
    dt = spec_d["dt"]
    dt0 = dt[0] if dt.numel() else None
    seg_max_fn, seg_argmax_fn = _seg_hooks(use_kernels)
    xs = schedule_to_device(schedule, dev)
    inst = np.asarray(schedule.xs["inst"])
    now = np.asarray(schedule.xs["inst_now"])
    n_ev = np.asarray(schedule.xs["val"]).sum(axis=1)
    live = (n_ev > 0) | inst
    widest = int(np.argmax(n_ev)) if capture.INPUTS is not None else -1
    acc = torch.zeros(N_ACC, dtype=torch.float64, device=dev)
    steps = installs = 0
    seen: dict = {}
    check = check_syncs and dev.type == "cuda"
    if check:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        for b in np.nonzero(live)[0].tolist():
            x = {k: v[b] for k, v in xs.items()}
            if inst[b]:
                _install_step(E, anchor, x, dt, float(now[b]))
                installs += 1
            _replay_step(E, anchor, acc, x, spec_d, dt, dt0, kind=statics,
                         charge=charge, const_dt=schedule.const_dt,
                         seg_max_fn=seg_max_fn, seg_argmax_fn=seg_argmax_fn,
                         capture=seen if b == widest else None)
            steps += 1
    finally:
        if check:
            torch.cuda.set_sync_debug_mode(mode)
    for name, inputs in seen.items():
        capture.keep_largest(name, int(n_ev[widest]), lambda: inputs)
    if stats is not None:
        stats.update(steps=steps, installs=installs, sync_scan=0)
    return E, anchor, acc


class TorchReplayEngine:
    """The device replay driver (counterpart of ``JaxReplayEngine``).

    Wraps (or builds) a :class:`~repro_torch.core.engine.ReplayEngine` that
    holds configuration, cache state and costs; ``replay`` runs the trace
    on ``device`` and syncs state + costs back, so the host state after a
    replay equals what the numpy engine of ``repro`` produces.
    """

    def __init__(self, *args, engine: ReplayEngine | None = None,
                 device=None, layout: StateLayout | str | None = None,
                 **kwargs):
        from ..kernels.packed_lookup import CliqueLookup

        self.device = resolve_device(device)
        self.layout = StateLayout.resolve(layout)   # dense only
        self.engine = engine if engine is not None else ReplayEngine(
            *args, **kwargs)
        self._spec, self._statics = cost_spec(
            self.engine.model, self.engine.env)
        #: the host schedule's item -> clique lookup on this device
        self.lookup = CliqueLookup(self.device)
        self.last_schedule = None
        self.last_stats: dict = {}

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
               win_prefix=None, use_kernels: bool = True) -> CostBreakdown:
        """Replay ``trace`` on the device, with clique generation every
        ``t_cg`` by ``clique_generator`` (a policy's ``on_window``).

        An AKPC policy the device clique generation admits runs it on the
        device; everything else takes the host-schedule replay.
        ``use_kernels=False`` runs the plain versions in place of the
        kernels on the same device (the comparison run).
        """
        from .cgm import replay_cgm
        from .cgm_schedule import wants_device_cgm
        from .schedule import build_schedule, pad_schedule, schedule_dims

        eng = self.engine
        keep_fn = pol = None
        if clique_generator is not None and t_cg is not None:
            pol = getattr(clique_generator, "__self__", None)
            keep_fn = getattr(pol, "item_keep", None)
            if pol is not None and wants_device_cgm(pol, trace, eng.model):
                return replay_cgm(
                    self, pol, trace, t_cg=t_cg, batch_size=batch_size,
                    next_cg0=next_cg0, win_prefix=win_prefix,
                    use_kernels=use_kernels)
            wire = getattr(pol, "wire_kernels", None)
            if wire is not None:
                wire(self.device, use_kernels)
        t0 = time.perf_counter()
        cg0 = getattr(pol, "cg_seconds", 0.0)
        self.lookup.use_kernel = use_kernels
        look0 = self.lookup.stats()
        with _span("host.schedule"):
            schedule = build_schedule(
                eng.state.partition, trace, clique_generator, t_cg,
                model=eng.model, env=eng.env, batch_size=batch_size,
                seed_new_cliques=eng.seed_new_cliques,
                next_cg0=next_cg0, win_prefix=win_prefix,
                lookup=self.lookup, progress=progress, layout=self.layout,
            )
        # shape ratchet: pad every chunk's tensors up to the largest dims
        # this engine has seen, as the reference does for its compiles
        dims = schedule_dims(schedule)
        prev = getattr(self, "_dims", None)
        if prev is not None:
            dims = {k: max(dims[k], prev[k]) for k in dims}
        self._dims = dims
        schedule = pad_schedule(schedule, dims)
        self.last_schedule = schedule
        t1 = time.perf_counter()
        stats: dict = {}
        part = schedule.final_partition
        with _span("host.scan"):
            E0, a0 = state_to_device(eng.state, schedule.n, self.device)
            E, anchor, acc = run_schedule(
                schedule, self._spec, self._statics, E0, a0,
                charge=eng.caching_charge, use_kernels=use_kernels,
                stats=stats)
            acc = acc.cpu().numpy()
            eng.state = CacheState.from_device(
                part, E[:part.k].cpu().numpy(),
                anchor[:part.k].cpu().numpy(), eng.m)
        t2 = time.perf_counter()
        eng._set_partition_caches(part)
        apply_acc(eng.costs, schedule, acc)
        if keep_fn is not None:
            # boundary evictions already ran on the device; this only
            # aligns the host engine's mask
            eng.set_item_keep(keep_fn())
        look = {key: v - look0[key]
                for key, v in self.lookup.stats().items()}
        cg_s = getattr(pol, "cg_seconds", 0.0) - cg0
        stats.update(
            path="host_schedule", nb=schedule.nb, ne=schedule.ne,
            const_dt=schedule.const_dt, sync_final=3,
            schedule_s=t1 - t0, cg_s=cg_s, **look,
            schedule_rest_s=t1 - t0 - cg_s - look["lookup_s"],
            scan_s=t2 - t1)
        self.last_stats = stats
        return eng.costs


def run_policy_torch(policy, trace, *, device=None, batch_size=None,
                     progress=None, use_kernels: bool = True):
    """Offline driver on the device: the counterpart of ``run_policy_jax``.

    Binds the policy, resolves the environment, installs an offline
    policy's initial partition, replays the trace in T_CG windows (clique
    generation only when the policy has a ``t_cg``), and returns a
    :class:`~repro_torch.core.policy.RunResult`.
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
