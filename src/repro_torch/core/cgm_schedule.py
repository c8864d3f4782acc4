"""Host half of the device clique generation: schedule, spec, gating, sync.

A copy of the host functions of ``repro.core.cgm_jax``: the partition-free
replay schedule (raw request batches cut on the T_CG grid, with the
boundary steps flagged), the hot-set capacity ``h`` and window buffer
capacity ``wcap`` that size the device workspace, the CGM hyperparameters
as scalars, the gate :func:`wants_device_cgm`, and the fold of a device run
back into the policy.  Nothing here touches the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cliques import CliquePartition
from .crm import WindowCRM
from .replay import NE_TARGET, _bucket

#: device CGM is gated on the PADDED HOT CAPACITY h, not the catalog
#: size — the (h, h) workspace and (2h, 2h) merge matrices stay cheap
#: and the f32 edge counters stay exact for any h below this bound
MAX_DEVICE_CGM_HOT = 2048
#: f32 exactness bound for the CRM / X integer counters
_F32_EXACT = 1 << 24


def hot_capacity(n: int, max_slots: int, hot_dims) -> int:
    """Padded hot-set capacity for a window of ``max_slots`` item slots.

    ``hot_dims`` is a list of ``(top_frac, of_catalog)`` pairs; the
    capacity is the max over them.  The hot
    set requires a positive window count, so it can never exceed the
    window's distinct support (≤ ``max_slots``) even when ``top_frac``
    is taken of the catalog; the bucket keeps shapes few.
    """
    need = 1
    for frac, of_catalog in hot_dims:
        base = n if of_catalog else min(n, int(max_slots))
        need = max(need, min(n, int(max_slots),
                             max(1, int(round(base * float(frac))))))
    return min(n, _bucket(need, 32, 32))


def _max_window_requests(trace, t_cg: float) -> int:
    """Upper bound on request rows in any one T_CG window.

    Every window's requests lie inside a half-open span of length
    ``t_cg`` starting at a request time (boundaries fire at request
    times and the grid advances by ``t_cg``), so the sliding-window
    count over request-aligned starts dominates all real windows —
    including the open tail window.
    """
    times = np.asarray(trace.times, np.float64)
    if times.size == 0:
        return 0
    ends = np.searchsorted(times, times + float(t_cg), side="left")
    return int((ends - np.arange(times.size)).max())


# ---------------------------------------------------------------------------
# the partition-free schedule: raw request tensors + boundary flags
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CGMSchedule:
    """Raw request batches of one trace, cut on the T_CG grid.

    There are no event tensors and no install records — events and
    partitions are derived ON DEVICE.  ``xs`` leading axis is nb (replay
    steps); a step never straddles a T_CG boundary, and a step whose window begins a
    new T_CG period carries ``cg=True`` + the boundary evaluation time.
    ``h`` / ``wcap`` size the compact boundary workspace: padded hot
    capacity and the window request-row buffer (``win_rows`` /
    ``win_slots`` record the raw per-window maxima they derive from).
    """

    n: int
    m: int
    nb: int
    B: int                      # requests per step (padded)
    d: int                      # item slots per request
    const_dt: bool              # device CGM requires uniform dt
    uses_sizes: bool
    xs: dict
    n_requests: int
    n_item_requests: int
    boundary_steps: np.ndarray  # (n_boundaries,) step indices
    win_start: int              # open-window start index into the trace
    boundary_hit: bool
    next_cg: float | None
    h: int                      # padded hot-set capacity
    wcap: int                   # window request-row buffer capacity
    win_rows: int               # max request rows in any one window
    win_slots: int              # max item slots in any one window (≤ n)


def build_cgm_schedule(
    trace,
    t_cg: float,
    *,
    uses_sizes: bool,
    batch_size: int | None = None,
    next_cg0: float | None = None,
    hot_dims=None,
    prefix_rows: int = 0,
    prefix_slots: int = 0,
) -> CGMSchedule:
    """Cut the trace into boundary-aligned request batches.

    The walk is the same T_CG grid as ``build_schedule`` (and the numpy
    ``ReplayEngine.replay``): a boundary fires when the next request
    lies at/after ``next_cg``, is evaluated at that request's time, and
    empty periods are skipped with a single firing.  No clique
    generation happens here — the boundary merely flags the step.

    ``hot_dims`` is the ``(top_frac, of_catalog)`` list over the lanes
    that will share this schedule (default: a full-support lane, the
    conservative ``h`` = window support); ``prefix_rows`` /
    ``prefix_slots`` account a session's already-open window so the
    head window's buffer capacity covers it.
    """
    times, servers, items = trace.times, trace.servers, trace.items
    R = int(times.shape[0])
    d = int(items.shape[1]) if items.ndim == 2 else 1
    if batch_size is not None:
        bs = max(1, int(batch_size))
    else:
        bs = max(1, NE_TARGET // max(1, d))
    if R > 0:
        next_cg = (float(next_cg0) if next_cg0 is not None
                   else float(times[0]) + t_cg)
    else:
        next_cg = next_cg0 if next_cg0 is not None else np.inf

    slices: list[tuple[int, int, float | None]] = []
    pending_cg: float | None = None
    win_start = 0
    boundary_hit = False
    pos = 0
    while pos < R:
        cut = int(np.searchsorted(times, next_cg, side="left"))
        if cut <= pos:
            t = float(times[pos])
            pending_cg = t
            win_start = pos
            boundary_hit = True
            while next_cg <= t:
                next_cg += t_cg
            continue
        stop = min(pos + bs, cut)
        slices.append((pos, stop, pending_cg))
        pending_cg = None
        pos = stop

    nb_raw = max(1, len(slices))
    nb = _bucket(nb_raw, 4, 4)
    B = _bucket(max((s - p for p, s, _ in slices), default=1), 32, 32)

    # per-window row/slot accounting: a boundary slice CLOSES the window
    # accumulated so far (head window includes the session prefix; the
    # tail window stays open but still occupies the buffer)
    cur_rows, cur_slots = int(prefix_rows), int(prefix_slots)
    max_rows, max_slots = cur_rows, cur_slots
    for p, s, cg_now in slices:
        if cg_now is not None:
            cur_rows, cur_slots = 0, 0
        cur_rows += s - p
        cur_slots += (s - p) * d
        max_rows = max(max_rows, cur_rows)
        max_slots = max(max_slots, cur_slots)
    win_slots = min(trace.n, max_slots)
    # +B headroom: a step writes its whole padded block at offset wlen
    # before the validity mask trims it, so the buffer must absorb one
    # full batch past the worst window
    wcap = _bucket(max_rows + B, 64, 64)
    if hot_dims is None:
        hot_dims = [(1.0, False)]
    h = hot_capacity(trace.n, win_slots, hot_dims)

    t_pad = float(times[-1]) if R else 0.0
    xs = {
        "items": np.full((nb, B, d), -1, np.int32),
        "servers": np.zeros((nb, B), np.int32),
        "times": np.full((nb, B), t_pad, np.float64),
        "cg": np.zeros(nb, bool),
        "now": np.zeros(nb, np.float64),
        "nreq": np.zeros(nb, np.int32),
    }
    boundary_steps = []
    for b, (p, s, cg_now) in enumerate(slices):
        w = s - p
        xs["items"][b, :w] = items[p:s]
        xs["servers"][b, :w] = servers[p:s]
        xs["times"][b, :w] = times[p:s]
        xs["times"][b, w:] = times[s - 1]
        xs["nreq"][b] = w
        if cg_now is not None:
            xs["cg"][b] = True
            xs["now"][b] = cg_now
            boundary_steps.append(b)

    return CGMSchedule(
        n=trace.n, m=trace.m, nb=nb, B=B, d=d, const_dt=True,
        uses_sizes=uses_sizes, xs=xs,
        n_requests=R, n_item_requests=int((items >= 0).sum()),
        boundary_steps=np.asarray(boundary_steps, np.int32),
        win_start=win_start, boundary_hit=boundary_hit,
        next_cg=None if R == 0 else float(next_cg),
        h=h, wcap=wcap, win_rows=max_rows, win_slots=win_slots,
    )


def pad_cgm_schedule(schedule: CGMSchedule, dims: dict) -> CGMSchedule:
    """Pad a CGM schedule's xs + capacities up to shared ``dims``.

    Pads to the running max dims ``{"nb", "B", "d", "h", "W"}`` so that
    schedules of several chunks share one workspace geometry.  Growing B also grows the per-step block write,
    so ``wcap`` is re-derived to keep ``win_rows + B <= wcap``.
    """
    s = schedule
    nb = max(dims.get("nb", s.nb), s.nb)
    B = max(dims.get("B", s.B), s.B)
    d = max(dims.get("d", s.d), s.d)
    h = max(dims.get("h", s.h), s.h)
    wcap = max(dims.get("W", s.wcap), s.wcap,
               _bucket(s.win_rows + B, 64, 64))
    if (nb, B, d) == (s.nb, s.B, s.d) and (h, wcap) == (s.h, s.wcap):
        return s
    xs0 = s.xs
    if (nb, B, d) != (s.nb, s.B, s.d):
        t_pad = float(xs0["times"][-1, -1]) if s.nb else 0.0
        items = np.full((nb, B, d), -1, np.int32)
        items[: s.nb, : s.B, : s.d] = xs0["items"]
        servers = np.zeros((nb, B), np.int32)
        servers[: s.nb, : s.B] = xs0["servers"]
        times = np.full((nb, B), t_pad, np.float64)
        times[: s.nb, : s.B] = xs0["times"]
        # padded request slots reuse the step's last real time so the
        # dedup keys stay inert
        times[: s.nb, s.B:] = xs0["times"][:, -1:]
        cg = np.zeros(nb, bool)
        cg[: s.nb] = xs0["cg"]
        now = np.zeros(nb, np.float64)
        now[: s.nb] = xs0["now"]
        nreq = np.zeros(nb, np.int32)
        nreq[: s.nb] = xs0["nreq"]
        xs = dict(items=items, servers=servers, times=times, cg=cg,
                  now=now, nreq=nreq)
    else:
        xs = xs0
    return dataclasses.replace(s, nb=nb, B=B, d=d, xs=xs, h=h, wcap=wcap)


def cgm_spec(cfg, params, n: int) -> dict:
    """The CGM hyperparameters as host scalars.

    theta / gamma enter f32 comparisons on the host path (NEP-50 weak
    scalars against f32 CRM/density matrices), so both are shipped in
    the dtype each comparison actually runs in.
    """
    omega = int(params.omega) if cfg.enable_split else int(n)
    return {
        "theta": np.float32(params.theta),
        "gamma32": np.float32(params.gamma),
        "gamma": np.float64(params.gamma),
        "omega": np.int32(omega),
        "omega_f": np.float64(omega),
        "top_frac": np.float64(cfg.top_frac),
        "of_catalog": np.bool_(cfg.top_frac_of == "catalog"),
    }


def partition_from_of(n: int, of: np.ndarray) -> CliquePartition:
    """Dense device slot map -> host partition; slot order IS group order,
    so ``result.clique_of == of`` element for element.  Every slot below
    ``of.max()`` must be used (the device ranks slots densely)."""
    of = np.asarray(of)
    k = int(of.max()) + 1 if of.size else 0
    order = np.argsort(of, kind="stable")
    sizes = np.bincount(of, minlength=k)
    groups = [tuple(g) for g in np.split(order, np.cumsum(sizes)[:-1])] \
        if k else []
    return CliquePartition.from_cliques(n, groups)


def sync_policy_from_run(policy, schedule, ofs, final, part) -> None:
    """Fold the device run's window bookkeeping back into the policy, as
    if ``on_window`` had run per boundary on the host."""
    nbd = int(schedule.boundary_steps.size)
    if nbd == 0:
        return
    for b in schedule.boundary_steps:
        sizes = np.bincount(np.asarray(ofs[int(b)])).astype(np.int64)
        policy.size_history.append(sizes[sizes > 1])
    policy.n_windows += nbd
    policy._partition = part
    policy._prev_crm = WindowCRM.from_compact(
        final["p_idx"], final["praw"], final["pnorm"], final["pbin"],
        n=schedule.n)


def policy_hot_dims(policy) -> list:
    """The ``(top_frac, of_catalog)`` hot-capacity dims of one policy."""
    cfg = policy.config
    return [(float(cfg.top_frac), cfg.top_frac_of == "catalog")]


def wants_device_cgm(policy, trace, model) -> bool:
    """Eligibility gate for the device-resident CGM path.

    Requires an unmodified AKPC-family policy (the device merge/split
    mirrors the reference ``AKPCPolicy.on_window`` exactly) and a uniform
    keepalive dt.  The catalog size does not gate the path: the boundary
    workspace is sized by the padded hot capacity ``h`` (window working
    set x ``top_frac``), so any catalog whose ``h`` stays under
    ``MAX_DEVICE_CGM_HOT`` and whose window request counts keep the f32
    co-occurrence counters exact is admitted.  Lanes that run the
    approximate merge OUTSIDE the pruning regime (the w/o-CS ablation)
    need a (2n, 2n) merge space, so those stay small-catalog only.
    Custom ``crm_matmul`` / ``pair_edges`` hooks belong to the host clique
    generation, so a policy with them takes the host path.
    """
    from .akpc import AKPCConfig
    from .policy import AKPCPolicy

    cfg = getattr(policy, "config", None)
    if not isinstance(cfg, AKPCConfig):
        return False
    if not isinstance(policy, AKPCPolicy) \
            or type(policy).on_window is not AKPCPolicy.on_window:
        return False
    t_cg = getattr(policy, "t_cg", None)
    if t_cg is None:
        return False
    if cfg.crm_matmul is not None or cfg.pair_edges is not None:
        return False
    dt = np.asarray(model.dt(), np.float64)
    if dt.size and not (dt == dt[0]).all():
        return False
    wmax = _max_window_requests(trace, t_cg)
    if wmax + NE_TARGET >= _F32_EXACT:
        return False
    d_max = max(1, int(getattr(trace, "d_max", 1)))
    smax = min(trace.n, wmax * d_max)
    if hot_capacity(trace.n, smax, policy_hot_dims(policy)) \
            > MAX_DEVICE_CGM_HOT:
        return False
    if cfg.enable_approx_merge:
        omega = int(cfg.params.omega) if cfg.enable_split else int(trace.n)
        prune = omega > 2 and float(cfg.params.gamma) > (omega - 2) / omega
        if not prune and trace.n > 256:
            return False
    return True
