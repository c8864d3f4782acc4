"""Multi-scenario sweep engine over the device replay (port of ``repro.core.sweep``).

The paper's cost curves (Figs. 5-10) sweep hyperparameter x cost-model x
trace grids.  :class:`SweepEngine` makes the SCENARIO the batch axis:

1. every grid point is a :class:`SweepPoint` (policy + trace + pricing
   scenario);
2. points that share (trace, clique-generation hyperparameters, batch
   size) share ONE host-built
   :class:`~repro_torch.core.schedule.ReplaySchedule`: an alpha sweep
   runs clique generation once, not once per alpha, because the partition
   trajectory depends on the trace and the CGM knobs only, never on prices
   or cache state;
3. the scenarios that share a schedule are the lanes of ONE
   :func:`~repro_torch.core.replay.run_schedule` call: cost spec and state
   carry a leading lane axis, the schedule's event tensors are shared
   (the reference's ``jax.vmap`` with ``in_axes=(0, 0, None)``);
4. groups that share padded state geometry, dt mode, sizes, step-tensor
   set, statics and caching charge (the reference's cohort key) are the
   lanes of ONE :func:`~repro_torch.core.replay.run_schedules` call: each
   distinct schedule goes up once, and each lane reads its schedule's
   rows (the reference's ``in_axes=(0, 0, 0)``); a one-group cohort keeps
   the shared form of step 3;
5. each point comes back as the :class:`~repro_torch.core.policy.RunResult`
   the serial ``run_policy`` returns, cost for cost at 1e-9, with its final
   :class:`~repro_torch.core.engine.CacheState`.

Backends: ``"torch"`` (default) is that lane-stacked replay on ``device``
(the reference's ``"jax"``); ``"serial"`` runs one port ``run_policy`` per
point on the same device (the reference's ``"numpy"``): the baseline a
sweep is timed against.

Device-CGM super-groups (AKPC points of one trace and pricing that differ
only in theta / gamma / omega / top_frac, the fig7 axes) share ONE
partition-free CGM schedule and replay as the lanes of one laned device
clique generation (:func:`~repro_torch.core.cgm_lanes.run_cgm_lanes`, the
reference's vmapped ``run_cgm_schedule``): zero host clique-generation
calls, one schedule a super-group.

A trace-shard point builds one schedule a shard; a group of shard
points (one share key) replays ``scenarios x shards`` lanes, lane ``li *
S_sh + j`` scenario li on shard j, in one ``run_schedules`` call, and
each scenario's shards merge into one RunResult with ``shard_stats``
(:func:`_merge_shard_results`), as the reference does.

Under a ``bucketed`` :class:`~repro_torch.core.state_layout.StateLayout`
the schedules are built at the layout's padded state dims, so points of
different (n, m) whose dims round to the same bucket are one cohort and
replay as the lanes of one scan (``last_stats["groups"]``: one record a
scan); the device-CGM super-groups keep their dense-n carry.  The mesh
(and with it the ``row_sharded`` layout) is refused (ROADMAP queue 1,
item 5), and so is a cost model without a device formula: the port never
falls back to another backend or to the CPU.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Sequence

import numpy as np

from .cliques import CliquePartition
from .cost import CacheEnvironment, CostBreakdown, get_cost_model
from .policy import RunResult, get_policy
from .replay import (
    build_host_schedule,
    cost_spec,
    pad_spec_cols,
    replay_lanes,
    resolve_device,
    run_policy_torch,
)
from .state_layout import StateLayout

#: registry policies whose clique-generation trajectory is fully determined
#: by (trace, t_cg, top_frac, top_frac_of, theta, gamma, omega, split/merge
#: flags): the key under which SweepEngine shares schedules.  Other
#: policies always get a private schedule.
SHAREABLE_POLICIES = (
    "no_packing", "packcache", "dp_greedy",
    "akpc", "akpc_no_acm", "akpc_base",
)
#: what the refusals name
_ROADMAP = "ROADMAP queue 1, item 5"


@dataclasses.dataclass
class SweepPoint:
    """One grid point: a registered policy replayed over one scenario.

    ``policy_kwargs`` go to :func:`~repro_torch.core.policy.get_policy`
    verbatim (``params``, ``t_cg``, ``top_frac``, ``env``, ``cost_model``,
    ...); ``tag`` is a caller label (results come back in input order).

    ``trace`` may also be a SEQUENCE of traces, the trace-shard axis:
    shards of one long trace, or per-seed replicas of one workload.  The
    point then replays every shard and comes back as ONE RunResult with
    the per-shard costs merged and ``shard_stats`` holding the mean +- CI
    of the per-shard totals.  All shards must share (n, m).
    """

    policy: str
    trace: Any
    policy_kwargs: dict = dataclasses.field(default_factory=dict)
    tag: str = ""


def _shards_of(trace) -> tuple | None:
    """The shard tuple of a sharded ``SweepPoint.trace`` (else None)."""
    if isinstance(trace, (list, tuple)):
        shards = tuple(trace)
        if not shards:
            raise ValueError("SweepPoint.trace sequence is empty")
        n, m = shards[0].n, shards[0].m
        for tr in shards[1:]:
            if tr.n != n or tr.m != m:
                raise ValueError(
                    "trace shards must share the catalog/server shape "
                    f"(n, m): got ({n}, {m}) vs ({tr.n}, {tr.m})")
        return shards
    return None


def _shard_stats(totals: list) -> dict:
    """mean +- 95% CI (normal approx) of the per-shard total costs."""
    a = np.asarray(totals, np.float64)
    std = float(a.std(ddof=1)) if a.size > 1 else 0.0
    return {
        "n": int(a.size),
        "totals": [float(t) for t in totals],
        "mean": float(a.mean()),
        "std": std,
        "ci95": 1.96 * std / float(np.sqrt(a.size)),
    }


def _merge_shard_results(subs: list) -> RunResult:
    """Fold per-shard RunResults into one."""
    merged = dataclasses.replace(subs[0].costs)
    for r in subs[1:]:
        merged.merge(r.costs)
    return dataclasses.replace(
        subs[0], costs=merged,
        cg_seconds=sum(r.cg_seconds for r in subs),
        wall_seconds=sum(r.wall_seconds for r in subs),
        shard_stats=_shard_stats([r.costs.total for r in subs]))


def _cgm_key(policy) -> tuple:
    """The clique-generation-relevant knobs of a registry policy."""
    p = policy.params
    cfg = getattr(policy, "config", None)
    if cfg is not None:                     # AKPCPolicy variants
        return (cfg.t_cg, cfg.top_frac, cfg.top_frac_of, cfg.enable_split,
                cfg.enable_approx_merge, cfg.params.theta, cfg.params.gamma,
                cfg.params.omega)
    user_part = getattr(policy, "_user_partition", None)
    return (policy.t_cg, getattr(policy, "top_frac", None),
            getattr(policy, "top_frac_of", None), p.theta,
            None if user_part is None else id(user_part))


class SweepEngine:
    """Replay a grid of scenarios with one lane-stacked scan per group."""

    def __init__(self, backend: str = "torch", mesh=None,
                 layout: StateLayout | str | None = None, device=None):
        if backend not in ("torch", "serial"):
            raise ValueError(f"unknown sweep backend {backend!r}; the port "
                             "has 'torch' and 'serial'")
        if mesh is not None:
            raise NotImplementedError(
                f"a sweep mesh is not ported yet ({_ROADMAP}); the port "
                "sweeps on one card")
        self.backend = backend
        self.layout = StateLayout.resolve(layout)
        self.device = resolve_device(device)
        #: wall seconds of the most recent :meth:`run` (schedules + device)
        self.last_wall = 0.0
        #: host schedules the most recent run built
        self.last_n_schedules = 0
        #: the most recent run's schedule builds and laned scans (seconds)
        self.last_stats: dict = {}
        #: per point of the most recent run: the (windows, n) slot maps at
        #: its T_CG boundaries if it ran in a device-CGM super-group, else
        #: None
        self.last_cgm_ofs: list = []

    # ------------------------------------------------------------------
    def run(self, points: Sequence[SweepPoint]) -> list[RunResult]:
        t0 = _time.perf_counter()
        if self.backend == "serial":
            out = [self._run_serial(pt) for pt in points]
            self.last_n_schedules = len(points)
        else:
            out = self._run_lanes(points)
        self.last_wall = _time.perf_counter() - t0
        return out

    def _run_policy(self, pt: SweepPoint, trace) -> RunResult:
        return run_policy_torch(get_policy(pt.policy, **pt.policy_kwargs),
                                trace, device=self.device)

    def _run_serial(self, pt: SweepPoint) -> RunResult:
        shards = _shards_of(pt.trace)
        if shards is not None:
            return _merge_shard_results(
                [self._run_policy(pt, tr) for tr in shards])
        return self._run_policy(pt, pt.trace)

    # ------------------------------------------------------------------
    def _prepare(self, pt: SweepPoint) -> dict:
        """Policy, pricing spec and schedule-share key of one point."""
        shards = _shards_of(pt.trace)
        tr0 = shards[0] if shards is not None else pt.trace
        policy = get_policy(pt.policy, **pt.policy_kwargs)
        policy.bind(tr0.n, tr0.m)
        env = CacheEnvironment.resolve(
            getattr(policy, "env", None), tr0, policy.params)
        model = get_cost_model(getattr(policy, "cost_model", "table1"), env)
        spec, statics = cost_spec(model, env)
        dt = spec["dt"]
        const_dt = env.m == 0 or bool((dt == dt[0]).all())
        ncol = self.layout.state_cols(env.m)
        if ncol != env.m:
            spec = pad_spec_cols(spec, ncol)
        bs = policy.batch_size              # as run_policy_torch reads it
        seed = getattr(policy, "seed_new_cliques", True)
        sizes_fp = (None if not model.uses_sizes
                    else (id(env.item_sizes)
                          if env.item_sizes is not None else "unit"))
        if pt.policy in SHAREABLE_POLICIES:
            tid = (tuple(id(tr) for tr in shards)
                   if shards is not None else id(pt.trace))
            skey = (tid, pt.policy, _cgm_key(policy), bs, const_dt,
                    model.uses_sizes, sizes_fp, seed)
        else:
            skey = object()                 # never shared
        return {"pt": pt, "policy": policy, "spec": spec, "statics": statics,
                "skey": skey, "sizes_fp": sizes_fp, "model": model,
                "env": env, "bs": bs, "seed": seed, "shards": shards,
                "charge": getattr(policy, "caching_charge", "requested")}

    def _device_cgm_groups(self, prepared) -> list:
        """The reference's device-CGM super-groups, as lists of point
        indices: AKPC points of one trace and pricing that the device
        clique generation admits, with at least two distinct CGM keys."""
        from .cgm_schedule import wants_device_cgm

        groups: dict = {}
        for i, pr in enumerate(prepared):
            pt, policy = pr["pt"], pr["policy"]
            cfg = getattr(policy, "config", None)
            if (pr["shards"] is not None
                    or pt.policy not in SHAREABLE_POLICIES or cfg is None
                    or not self.layout.supports_device_cgm(
                        pt.trace.n, pt.trace.m)):
                continue
            dkey = (id(pt.trace), cfg.t_cg, pr["bs"], pr["statics"],
                    pr["charge"], pr["model"].uses_sizes, pr["sizes_fp"],
                    pr["seed"], cfg.enable_split, cfg.enable_approx_merge)
            groups.setdefault(dkey, []).append(i)
        out = []
        for idxs in groups.values():
            # grouping before the admission test gives the reference's
            # groups (the test only drops points), and spares a group
            # with one CGM key the test, which walks the whole trace
            if len({_cgm_key(prepared[i]["policy"]) for i in idxs}) < 2:
                continue
            ok = [i for i in idxs if wants_device_cgm(
                prepared[i]["policy"], prepared[i]["pt"].trace,
                prepared[i]["model"])]
            if len({_cgm_key(prepared[i]["policy"]) for i in ok}) >= 2:
                out.append(ok)
        return out

    def _replay_cgm_group(self, lanes: list) -> tuple[list, np.ndarray]:
        """One super-group (prepared points) as the lanes of one laned
        device clique generation, from singletons: one RunResult a lane,
        as the serial ``replay_cgm`` of its point returns it, and the (S,
        windows, n) slot maps at the boundaries."""
        from .cgm_lanes import init_lane_carry, run_cgm_lanes, stack_cspecs
        from .cgm_schedule import (
            build_cgm_schedule, cgm_spec, partition_from_of, policy_hot_dims)
        from .engine import CacheState
        from .replay import apply_acc

        g0 = lanes[0]
        trace = g0["pt"].trace
        n, m = trace.n, trace.m
        cfg0 = g0["policy"].config
        uses_sizes = bool(g0["model"].uses_sizes)
        item_sizes = g0["env"].sizes() if uses_sizes else None
        S = len(lanes)
        t0 = _time.perf_counter()
        sched = build_cgm_schedule(
            trace, cfg0.t_cg, uses_sizes=uses_sizes, batch_size=g0["bs"],
            hot_dims=[policy_hot_dims(pr["policy"])[0] for pr in lanes])
        spec = {k: np.stack([np.asarray(pr["spec"][k]) for pr in lanes])
                for k in g0["spec"]}
        cspec = stack_cspecs([cgm_spec(pr["policy"].config,
                                       pr["policy"].config.params, n)
                              for pr in lanes])
        carry0 = init_lane_carry(
            CacheState.fresh(CliquePartition.singletons(n), m), S,
            schedule=sched, uses_sizes=uses_sizes, item_sizes=item_sizes,
            device=self.device)
        final, ofs, stats = run_cgm_lanes(
            sched, spec, g0["statics"], cspec, carry0, item_sizes,
            charge=g0["charge"], enable_split=cfg0.enable_split,
            enable_acm=cfg0.enable_approx_merge, seed_new=g0["seed"])
        host = {k: final[k].cpu().numpy()
                for k in ("E", "anchor", "of", "acc")}
        ofs = ofs.cpu().numpy()
        wall = _time.perf_counter() - t0
        nbd = int(sched.boundary_steps.size)
        self.last_stats["cgm_groups"].append(
            {"lanes": S, "windows": nbd, "steps": sched.nb, "h": sched.h,
             "seconds": wall, **stats})
        out = []
        for lane, pr in enumerate(lanes):
            costs = CostBreakdown(model=pr["statics"][0])
            apply_acc(costs, sched, host["acc"][lane])
            part = (partition_from_of(n, host["of"][lane]) if nbd
                    else CliquePartition.singletons(n))
            hist = []
            for w in range(nbd):
                sz = np.bincount(ofs[lane, w]).astype(np.int64)
                hist.append(sz[sz > 1])
            out.append(RunResult(
                policy=pr["policy"].name, costs=costs,
                clique_sizes=part.sizes(), size_history=hist, n_windows=nbd,
                cg_seconds=0.0, wall_seconds=wall / S,
                config=pr["policy"].config,
                state=CacheState(
                    partition=part, E=host["E"][lane][: part.k].copy(),
                    anchor=host["anchor"][lane][: part.k].astype(np.int32),
                    m=m),
                loop_stats={"path": "sweep_cgm_lanes", **stats}))
        return out, ofs

    def _build(self, policy, trace, pr) -> dict:
        """One host schedule (clique generation on the host, lookups and
        CGM hooks on the card), with the policy's window bookkeeping."""
        from ..kernels.packed_lookup import CliqueLookup

        part0 = policy.initial_partition(trace)
        if part0 is None:
            part0 = CliquePartition.singletons(trace.n)
        gen = policy.on_window if policy.t_cg is not None else None
        schedule, stats = build_host_schedule(
            part0, trace, gen, policy.t_cg, model=pr["model"], env=pr["env"],
            lookup=CliqueLookup(self.device), batch_size=pr["bs"],
            seed_new_cliques=pr["seed"], layout=self.layout)
        self.last_stats["builds"].append({
            "policy": policy.name, "schedule_s": stats["schedule_s"],
            "cg_s": stats["cg_s"], "lookup_s": stats["lookup_s"],
            "lookup_calls": stats["lookup_calls"],
            "lookup_table_bytes_up": stats["lookup_table_bytes_up"]})
        return {
            "schedule": schedule,
            "n_windows": getattr(policy, "n_windows", 0),
            "cg_seconds": getattr(policy, "cg_seconds", 0.0),
            "size_history": list(getattr(policy, "size_history", [])),
            "clique_sizes": schedule.final_partition.sizes(),
        }

    def _replay_group(self, recs: list, rows: list, lanes: list, statics,
                      charge, members: int = 1) -> list:
        """One scan over ``lanes`` (prepared points): lane s replays
        ``recs[rows[s]]``'s schedule under its spec, one laned
        ``run_schedule`` when every lane shares one schedule, else one
        ``run_schedules``.  One RunResult per lane."""
        S = len(lanes)
        costs = [CostBreakdown(model=statics[0]) for _ in lanes]
        states, stats = replay_lanes(
            [r["schedule"] for r in recs], [pr["spec"] for pr in lanes],
            statics, costs, device=self.device, rows=rows, charge=charge)
        s0 = recs[0]["schedule"]
        self.last_stats["groups"].append(
            {"lanes": S, "members": members, "schedules": len(recs),
             "steps": stats["steps"], "nb": s0.nb, "ne": s0.ne,
             "const_dt": s0.const_dt, "xs_bytes": stats["xs_bytes"],
             "scan_s": stats["scan_s"]})
        out = []
        for pr, c, st, r in zip(lanes, costs, states, rows):
            rec = recs[r]
            out.append(RunResult(
                policy=pr["policy"].name,
                costs=c,
                clique_sizes=rec["clique_sizes"],
                size_history=list(rec["size_history"]),
                n_windows=rec["n_windows"],
                cg_seconds=rec["cg_seconds"],
                wall_seconds=stats["scan_s"] / S,
                config=getattr(pr["policy"], "config", None),
                state=st,
                loop_stats={"path": "sweep_lanes", **stats},
            ))
        return out

    def _run_lanes(self, points) -> list[RunResult]:
        self.last_stats = {"groups": [], "builds": [], "cgm_groups": []}
        self.last_cgm_ofs = [None] * len(points)
        prepared = [self._prepare(pt) for pt in points]
        cgm_groups = self._device_cgm_groups(prepared)
        on_device = {i for idxs in cgm_groups for i in idxs}
        groups: dict = {}
        sh_groups: dict = {}
        for i, pr in enumerate(prepared):
            if i in on_device:
                continue
            dst = sh_groups if pr["shards"] is not None else groups
            dst.setdefault((pr["skey"], pr["statics"], pr["charge"]),
                           []).append(i)

        # -- one host schedule per distinct share key -----------------------
        schedules: dict = {}
        for (skey, _statics, _charge), idxs in groups.items():
            if skey in schedules:
                continue
            g0 = prepared[idxs[0]]
            schedules[skey] = self._build(g0["policy"], g0["pt"].trace, g0)

        # -- pad each (state geometry, dt mode, sizes) cohort to shared dims
        pads: dict = {}
        for rec in schedules.values():
            s = rec["schedule"]
            pads.setdefault(
                (s.state_rows, s.state_cols, s.const_dt, s.uses_sizes),
                []).append(rec)
        for recs in pads.values():
            _pad_shared(recs)

        results: list[RunResult | None] = [None] * len(prepared)
        # -- one scan per cohort: groups sharing padded state geometry, the
        # step-tensor set (e.g. TTL's "nokeep"), statics and charge --------
        cohorts: dict = {}
        for (skey, statics, charge), idxs in groups.items():
            s = schedules[skey]["schedule"]
            cohorts.setdefault(
                ((s.state_rows, s.state_cols, s.const_dt, s.uses_sizes),
                 frozenset(s.xs), statics, charge), []).append((skey, idxs))
        for (_geom, _keys, statics, charge), members in cohorts.items():
            recs = [schedules[skey] for skey, _ in members]
            lane_idx = [i for _, idxs in members for i in idxs]
            rows = [g for g, (_, idxs) in enumerate(members) for _ in idxs]
            res = self._replay_group(recs, rows,
                                     [prepared[i] for i in lane_idx],
                                     statics, charge, members=len(members))
            for i, r in zip(lane_idx, res):
                results[i] = r

        # -- trace shards: one schedule a shard, the group's scenarios x
        # shards the lanes of one scan (lane li * S_sh + j) -----------------
        n_shard_schedules = 0
        for (skey, statics, charge), idxs in sh_groups.items():
            g0 = prepared[idxs[0]]
            policy = g0["policy"]
            recs = []
            for tr in g0["shards"]:
                policy.bind(tr.n, tr.m)       # fresh CGM state per shard
                recs.append(self._build(policy, tr, g0))
            n_shard_schedules += len(recs)
            _pad_shared(recs)
            S_sh = len(recs)
            res = self._replay_group(
                recs, [j for _ in idxs for j in range(S_sh)],
                [prepared[i] for i in idxs for _ in range(S_sh)],
                statics, charge)
            for li, i in enumerate(idxs):
                results[i] = _merge_shard_results(
                    res[li * S_sh:(li + 1) * S_sh])

        # -- device-CGM super-groups: one laned clique generation each -----
        for idxs in cgm_groups:
            res, ofs = self._replay_cgm_group([prepared[i] for i in idxs])
            for lane, (i, r) in enumerate(zip(idxs, res)):
                results[i] = r
                self.last_cgm_ofs[i] = ofs[lane]
        self.last_n_schedules = (len(schedules) + n_shard_schedules
                                 + len(cgm_groups))
        self.last_stats.update(schedules=len(schedules),
                               shard_schedules=n_shard_schedules,
                               device_cgm_points=len(on_device))
        return results  # type: ignore[return-value]


def _pad_shared(recs: list) -> None:
    """Pad the schedules of ``recs`` (in place) to their largest dims, so
    that they can be the rows of one scan."""
    from .schedule import pad_schedule, schedule_dims

    dims_list = [schedule_dims(r["schedule"]) for r in recs]
    dims = {k: max(d[k] for d in dims_list) for k in dims_list[0]}
    for r, d0 in zip(recs, dims_list):
        if d0 != dims:
            r["schedule"] = pad_schedule(r["schedule"], dims)


def sweep_points(grid: Sequence[dict], backend: str = "torch", mesh=None,
                 layout: StateLayout | str | None = None,
                 device=None) -> list[RunResult]:
    """One-shot convenience: each grid entry is SweepPoint kwargs."""
    pts = [SweepPoint(**g) for g in grid]
    eng = SweepEngine(backend=backend, mesh=mesh, layout=layout,
                      device=device)
    return eng.run(pts)
