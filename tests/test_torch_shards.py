"""Lanes that each replay a schedule: trace shards and cohorts, on the CPU.

The scans' per-lane form (``seg_scan_step`` with (G, L) event rows and a
lane -> row map, the standalone scans with (S, L) starts) equals a loop of
one-lane scans and ``jax.vmap`` of the reference's jnp twins over values
AND starts; the shared form is unchanged.  ``run_schedules`` gives each
lane what an unlaned ``run_schedule`` of its schedule gives, the dump row
aside, under uniform and per-server dt with lanes whose installs fall on
different steps.  The sweep replays a sharded point's shards as the lanes
of one scan and a multi-group cohort as one scan, each point equal to the
reference's numpy sweep (``repro``'s ``SweepEngine(backend="numpy")``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import SweepEngine as RefSweepEngine
from repro.core import SweepPoint as RefSweepPoint
from repro.core import get_cost_model as ref_get_cost_model
from repro.core import get_policy as ref_get_policy
from repro.core import engine_jax as ref_ej
from repro.core.cliques import CliquePartition as RefPartition
from repro.core.sweep import SHAREABLE_POLICIES as REF_SHAREABLE
from repro.core.sweep import _cgm_key as ref_cgm_key
from repro.kernels.segment_reduce import (
    seg_running_argmax_jnp,
    seg_running_max_jnp,
)
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.bench import sweep_bench
from repro_torch.convert import env_from_arrays, trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    SweepEngine,
    SweepPoint,
    get_cost_model,
    get_policy,
)
from repro_torch.core.cliques import CliquePartition
from repro_torch.core.replay import (
    _install_step,
    cost_spec,
    fresh_state_arrays,
    run_schedule,
    run_schedules,
)
from repro_torch.core.schedule import build_schedule, pad_schedule, schedule_dims
from repro_torch.kernels import (
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
    seg_scan_step,
    seg_scan_step_plain,
)

T_CG = 0.73
INT_FIELDS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred")


def assert_same_costs(a, b):
    a, b = a.as_dict(), b.as_dict()
    for f in INT_FIELDS:
        assert a[f] == b[f], f"{f}: {a[f]} != {b[f]}"
    for f in ("transfer", "caching", "keepalive_rent", "total"):
        assert np.isclose(a[f], b[f], rtol=1e-9, atol=1e-9), \
            f"{f}: {a[f]} != {b[f]}"


# ---------------------------------------------------------------------------
# the scans' per-lane form
# ---------------------------------------------------------------------------
def _rows_inputs(G, L, m, seed):
    """(G, L) event rows of both scans (ties, -inf, random starts) as
    numpy arrays, and an (S, m) dt for S = 5 lanes over rows 0..G-1."""
    rng = np.random.default_rng(seed)

    def problem():
        t = rng.integers(0, 6, size=(G, L)) * 0.5
        cont = rng.random((G, L)) < 0.5
        t[cont] = rng.random(int(cont.sum())) * 7.0
        t[rng.random((G, L)) < 0.1] = -np.inf
        j = rng.integers(0, m, size=(G, L))
        s = rng.random((G, L)) < 0.2
        return t, j, s

    first, second = problem(), problem()
    rows = np.array([0, G - 1, 0, min(1, G - 1), G - 1], np.int64)
    dt = rng.integers(1, 4, size=(rows.size, m)) * 0.25
    return (*first, *second), rows, dt


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("L", [1, 9, 700])
def test_scan_step_rows_equal_per_lane_and_vmapped_twins(G, L):
    """``seg_scan_step`` with a row map equals a loop of one-lane calls on
    each lane's row, and ``jax.vmap`` of the jnp twins over values and
    starts; the CPU wrapper runs that plain version."""
    m = 6
    ev, rows, dt = _rows_inputs(G, L, m, seed=G * 1000 + L)
    tev = [torch.from_numpy(a) for a in ev]
    tdt, trows = torch.from_numpy(dt), torch.from_numpy(rows)
    v, bidx, vmax = seg_scan_step_plain(*tev, tdt, trows)
    assert v.shape == (rows.size, L) and bidx.dtype == torch.int64
    got = seg_scan_step(*tev, tdt, trows)
    for a, b in zip(got, (v, bidx, vmax)):
        assert torch.equal(a, b)
    for s, r in enumerate(rows.tolist()):
        one = seg_scan_step_plain(*(a[r] for a in tev), tdt[s:s + 1])
        for a, b in zip((v, bidx, vmax), one):
            assert torch.equal(a[s], b[0])
    t_a, j_a, s_a, t_m, j_m, s_m = (a[rows] for a in ev)
    va = t_a + np.take_along_axis(dt, j_a, axis=1)
    vm = t_m + np.take_along_axis(dt, j_m, axis=1)
    with jax.enable_x64(True):
        wv, wi = jax.vmap(seg_running_argmax_jnp, in_axes=(0, 0))(
            jnp.asarray(va), jnp.asarray(s_a))
        wm = jax.vmap(seg_running_max_jnp, in_axes=(0, 0))(
            jnp.asarray(vm), jnp.asarray(s_m))
    assert np.array_equal(v.numpy(), np.asarray(wv))
    assert np.array_equal(bidx.numpy(), np.asarray(wi))
    assert np.array_equal(vmax.numpy(), np.asarray(wm))


@pytest.mark.parametrize("L", [1, 9, 700])
def test_scan_step_shared_form_unchanged(L):
    """The shared (L,) form is what one row at rows all zero gives, and
    still equals ``jax.vmap`` of the twins with the starts unbatched."""
    m = 6
    ev, _, dt = _rows_inputs(1, L, m, seed=L)
    tev = [torch.from_numpy(a) for a in ev]
    tdt = torch.from_numpy(dt)
    shared = seg_scan_step_plain(*(a[0] for a in tev), tdt)
    zero = seg_scan_step_plain(*tev, tdt,
                               torch.zeros(dt.shape[0], dtype=torch.int64))
    for a, b in zip(shared, zero):
        assert torch.equal(a, b)
    t_a, j_a, s_a, t_m, j_m, s_m = (a[0] for a in ev)
    with jax.enable_x64(True):
        wv, wi = jax.vmap(seg_running_argmax_jnp, in_axes=(0, None))(
            jnp.asarray(t_a + dt[:, j_a]), jnp.asarray(s_a))
        wm = jax.vmap(seg_running_max_jnp, in_axes=(0, None))(
            jnp.asarray(t_m + dt[:, j_m]), jnp.asarray(s_m))
    assert np.array_equal(shared[0].numpy(), np.asarray(wv))
    assert np.array_equal(shared[1].numpy(), np.asarray(wi))
    assert np.array_equal(shared[2].numpy(), np.asarray(wm))


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("L", [1, 33, 1000])
def test_standalone_scans_take_lane_starts(S, L):
    """(S, L) values over (S, L) starts: each lane under its own starts,
    as the one-lane scans and ``jax.vmap`` over both operands give it."""
    rng = np.random.default_rng(S * 7 + L)
    v = rng.integers(0, 4, size=(S, L)).astype(np.float64)
    v[rng.random((S, L)) < 0.1] = -np.inf
    s = rng.random((S, L)) < 0.1
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    gm = seg_running_max(tv, ts)
    gv, gi = seg_running_argmax(tv, ts)
    for i in range(S):
        assert torch.equal(gm[i], seg_running_max_plain(tv[i], ts[i]))
        lv, li = seg_running_argmax_plain(tv[i], ts[i])
        assert torch.equal(gv[i], lv) and torch.equal(gi[i], li)
    with jax.enable_x64(True):
        wm = jax.vmap(seg_running_max_jnp, in_axes=(0, 0))(
            jnp.asarray(v), jnp.asarray(s))
        wv, wi = jax.vmap(seg_running_argmax_jnp, in_axes=(0, 0))(
            jnp.asarray(v), jnp.asarray(s))
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gi.numpy(), np.asarray(wi))


# ---------------------------------------------------------------------------
# run_schedules
# ---------------------------------------------------------------------------
def _ref_trace(seed, n_requests=1200, m=12, size_dist="unit"):
    return ref_synth_trace(RefSynthConfig(
        kind="netflix", n_items=60, n_servers=m, n_requests=n_requests,
        t_max=30.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed,
        size_dist=size_dist))


def _port_trace(ref):
    return trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)


def _shard_schedules(cost_model, seeds=(3, 4, 5)):
    """One akpc schedule a shard (padded to shared dims) and the pricing
    specs of five lanes."""
    scheds, specs = [], []
    for k, seed in enumerate(seeds):
        tr = _port_trace(_ref_trace(seed, size_dist="lognormal"))
        params = CostParams(alpha=0.6 + 0.1 * k)
        env = None
        if cost_model == "heterogeneous":
            env = CacheEnvironment.skewed(tr.n, tr.m, params,
                                          price_sigma=0.8, seed=1)
        pol = get_policy("akpc", params=params, env=env, t_cg=T_CG,
                         top_frac=1.0, cost_model=cost_model)
        pol.bind(tr.n, tr.m)
        env = CacheEnvironment.resolve(pol.env, tr, pol.params)
        model = get_cost_model(cost_model, env)
        scheds.append(build_schedule(CliquePartition.singletons(tr.n), tr,
                                     pol.on_window, pol.t_cg, model=model,
                                     env=env))
        specs.append(cost_spec(model, env))
    dims_list = [schedule_dims(s) for s in scheds]
    dims = {k: max(d[k] for d in dims_list) for k in dims_list[0]}
    scheds = [pad_schedule(s, dims) for s in scheds]
    return scheds, specs


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_run_schedules_lanes_equal_unlaned_runs(cost_model):
    """Five lanes over three shard schedules (rows 0, 2, 0, 1, 2: lanes
    share rows, installs fall on different steps a schedule): each lane's
    E and anchor equal an unlaned run of its schedule float for float
    (dump row aside), its costs at 1e-9; no schedule is copied a lane."""
    scheds, specs = _shard_schedules(cost_model)
    statics = specs[0][1]
    assert scheds[0].const_dt == (cost_model == "table1")
    insts = [np.nonzero(s.xs["inst"])[0] for s in scheds]
    assert not all(np.array_equal(insts[0], i) for i in insts[1:])
    rows = [0, 2, 0, 1, 2]
    lane_specs = [specs[(r + k) % 3][0] for k, r in enumerate(rows)]
    spec = {k: np.stack([sp[k] for sp in lane_specs]) for k in lane_specs[0]}
    n, m = scheds[0].n, scheds[0].m
    E0, a0 = fresh_state_arrays(n, m)
    S = len(rows)
    stats: dict = {}
    E, A, acc = run_schedules(
        scheds, spec, statics, torch.from_numpy(np.stack([E0] * S)),
        torch.from_numpy(np.stack([a0] * S)), rows=rows, stats=stats)
    assert stats["lanes"] == S and stats["schedules"] == 3
    live = np.zeros(scheds[0].nb, bool)
    for s in scheds:
        live |= (s.xs["val"].sum(axis=1) > 0) | s.xs["inst"]
    assert stats["steps"] == int(live.sum())
    for lane, r in enumerate(rows):
        E1, A1, acc1 = run_schedule(scheds[r], lane_specs[lane], statics,
                                    torch.from_numpy(E0.copy()),
                                    torch.from_numpy(a0.copy()))
        assert torch.equal(E[lane, :n], E1[:n])
        assert torch.equal(A[lane, :n], A1[:n])
        np.testing.assert_allclose(acc[lane].numpy(), acc1.numpy(),
                                   rtol=1e-9, atol=0.0)


def test_run_schedules_one_schedule_is_run_schedule():
    """G = 1 is the shared form: the laned ``run_schedule``'s bits."""
    scheds, specs = _shard_schedules("heterogeneous", seeds=(3,))
    spec = {k: np.stack([specs[0][0][k]] * 2) for k in specs[0][0]}
    E0, a0 = fresh_state_arrays(scheds[0].n, scheds[0].m)
    outs = [fn(torch.from_numpy(np.stack([E0] * 2)),
               torch.from_numpy(np.stack([a0] * 2)))
            for fn in (
                lambda E, A: run_schedules(scheds, spec, specs[0][1], E, A,
                                           rows=[0, 0]),
                lambda E, A: run_schedule(scheds[0], spec, specs[0][1], E,
                                          A))]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_run_schedules_refuses_bad_rows_and_mixed_schedules():
    scheds, specs = _shard_schedules("heterogeneous", seeds=(3, 4))
    spec = {k: np.stack([specs[0][0][k]] * 2) for k in specs[0][0]}
    E0, a0 = fresh_state_arrays(scheds[0].n, scheds[0].m)
    E, A = (torch.from_numpy(np.stack([E0] * 2)),
            torch.from_numpy(np.stack([a0] * 2)))
    with pytest.raises(ValueError, match=r"lie in \[0, 2\)"):
        run_schedules(scheds, spec, specs[0][1], E, A, rows=[0, 2])
    bigger = pad_schedule(scheds[1], {k: v + 4 for k, v in
                                      schedule_dims(scheds[1]).items()})
    with pytest.raises(ValueError, match="padded dims"):
        run_schedules([scheds[0], bigger], spec, specs[0][1], E, A)


def test_install_step_lane_without_install_writes_dump_row_only():
    """Per-lane install records: a lane holding the padding records (no
    install at this step) keeps every live row, E and anchor; the other
    lane installs as the shared form installs it."""
    m, K = 4, 3
    rng = np.random.default_rng(0)
    E = torch.from_numpy(rng.random((2, K + 1, m)) * 5.0)
    anchor = torch.tensor([[1, 0, 2, -1], [3, 1, 0, -1]])
    i64 = torch.int64
    real = {
        "inst_mov_src": [2, K], "inst_mov_dst": [0, K],
        "inst_chg_rows": [1, K, K], "inst_chg_ok": [True, False, False],
        "inst_chg_src": [0, 1, 0, 0], "inst_chg_seg": [0, 0, 2, 2],
        "inst_seed_j": [2, 0, 0], "inst_seed_ok": [True, False, False],
    }
    pad = {   # the schedule's fills (schedule.py, pad_schedule)
        "inst_mov_src": [K, K], "inst_mov_dst": [K, K],
        "inst_chg_rows": [K, K, K], "inst_chg_ok": [False] * 3,
        "inst_chg_src": [0, 0, 0, 0], "inst_chg_seg": [2, 2, 2, 2],
        "inst_seed_j": [0, 0, 0], "inst_seed_ok": [False] * 3,
    }
    x = {k: torch.tensor([real[k], pad[k]],
                         dtype=torch.bool if "ok" in k else i64)
         for k in real}
    dt = torch.full((2, m), 0.5, dtype=torch.float64)
    now = torch.tensor([[1.0], [1.0]], dtype=torch.float64)
    E1, A1 = E.clone(), anchor.clone()
    _install_step(E1, A1, x, dt, now)
    assert torch.equal(E1[1, :K], E[1, :K])
    assert torch.equal(A1[1, :K], anchor[1, :K])
    E2, A2 = E[:1].clone(), anchor[:1].clone()
    _install_step(E2, A2, {k: v[0] for k, v in x.items()}, dt[:1], 1.0)
    assert torch.equal(E1[0, :K], E2[0, :K])
    assert torch.equal(A1[0, :K], A2[0, :K])


def test_replay_record_sums_to_the_accumulator():
    """The per-step record: its transfer column sums to the accumulator's
    transfer, its missed items to the items of missed events (unit
    sizes), and it is zero on steps the loop skips."""
    scheds, specs = _shard_schedules("table1", seeds=(4,))
    s = scheds[0]
    E0, a0 = fresh_state_arrays(s.n, s.m)
    rec = torch.zeros((s.nb, 1, 3), dtype=torch.float64)
    _, _, acc = run_schedule(s, specs[0][0], specs[0][1],
                             torch.from_numpy(E0), torch.from_numpy(a0),
                             record=rec)
    np.testing.assert_allclose(rec[:, 0, 0].sum().item(), acc[0].item(),
                               rtol=1e-12)
    dead = (s.xs["val"].sum(axis=1) == 0) & ~s.xs["inst"]
    assert not rec[torch.from_numpy(dead)].any()
    assert (rec[:, 0, 2] >= 0).all() and rec[:, 0, 2].sum() > 0


# ---------------------------------------------------------------------------
# the sweep: shards and cohorts against the reference's numpy sweep
# ---------------------------------------------------------------------------
def _ref_cohort_count(ref_pts) -> int:
    """The reference's scan calls for these (unsharded) points: one a
    cohort key ((state rows, cols, const_dt, uses_sizes), step-tensor set,
    statics, charge) over the distinct share keys (``sweep.py``)."""
    groups = {}
    for p in ref_pts:
        pol = ref_get_policy(p.policy, **p.policy_kwargs)
        tr = p.trace
        pol.bind(tr.n, tr.m)
        env = RefEnv.resolve(getattr(pol, "env", None), tr, pol.params)
        model = ref_get_cost_model(getattr(pol, "cost_model", "table1"), env)
        spec, statics = ref_ej.cost_spec(model, env)
        dt = spec["dt"]
        const_dt = bool((dt == dt[0]).all())
        sizes_fp = (None if not model.uses_sizes else
                    (id(env.item_sizes) if env.item_sizes is not None
                     else "unit"))
        seed = getattr(pol, "seed_new_cliques", True)
        skey = ((id(tr), p.policy, ref_cgm_key(pol), pol.batch_size,
                 const_dt, model.uses_sizes, sizes_fp, seed)
                if p.policy in REF_SHAREABLE else object())
        charge = getattr(pol, "caching_charge", "requested")
        if (skey, statics, charge) in groups:
            continue
        part0 = pol.initial_partition(tr) or RefPartition.singletons(tr.n)
        gen = pol.on_window if pol.t_cg is not None else None
        s = ref_ej.build_schedule(part0, tr, gen, pol.t_cg, model=model,
                                  env=env, batch_size=pol.batch_size,
                                  seed_new_cliques=seed)
        groups[skey, statics, charge] = (
            (s.state_rows, s.state_cols, s.const_dt, s.uses_sizes),
            frozenset(s.xs), statics, charge)
    return len(set(groups.values()))


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_sharded_points_equal_reference(cost_model):
    """Three shards x two alphas x (akpc, no_packing): each policy's shard
    group is one scan of 2 x 3 lanes over 3 schedules, and every point
    equals the reference numpy sweep with equal ``shard_stats``.  The
    heterogeneous environment carries its item sizes, as fig11's does: a
    sweep resolves a sharded point's environment on its first shard, so
    sizes that came from each shard's trace would price the other shards
    with the first one's (ROADMAP queue 3)."""
    refs = [_ref_trace(s) for s in (3, 4, 5)]
    ports = [_port_trace(r) for r in refs]
    ref_pts, port_pts = [], []
    for name in ("akpc", "no_packing"):
        for alpha in (0.7, 0.9):
            kw = dict(t_cg=T_CG, top_frac=1.0) if name == "akpc" else {}
            rp, pp = RefParams(alpha=alpha), CostParams(alpha=alpha)
            renv = penv = None
            if cost_model == "heterogeneous":
                renv = RefEnv.skewed(refs[0].n, refs[0].m, rp,
                                     price_sigma=0.8, size_sigma=0.4,
                                     seed=1)
                penv = env_from_arrays(ports[0].n, ports[0].m, pp,
                                       renv.lam_j, renv.mu_j,
                                       renv.item_sizes)
            ref_pts.append(RefSweepPoint(name, refs, dict(
                params=rp, env=renv, cost_model=cost_model, **kw)))
            port_pts.append(SweepPoint(name, ports, dict(
                params=pp, env=penv, cost_model=cost_model, **kw)))
    eng = SweepEngine(device="cpu")
    got = eng.run(port_pts)
    # a shard group a policy; under heterogeneous each alpha's environment
    # holds its own sizes array, which keys a group of its own
    lanes = 3 * (2 if cost_model == "table1" else 1)
    n_groups = 4 * 3 // lanes
    assert eng.last_n_schedules == 3 * n_groups
    assert [(g["lanes"], g["schedules"]) for g in
            eng.last_stats["groups"]] == [(lanes, 3)] * n_groups
    ref = RefSweepEngine(backend="numpy").run(ref_pts)
    serial = SweepEngine(backend="serial", device="cpu").run(port_pts)
    for a, b, c in zip(ref, got, serial):
        assert_same_costs(a.costs, b.costs)
        assert b.shard_stats["n"] == 3
        for key in ("totals", "mean", "std", "ci95"):
            np.testing.assert_allclose(b.shard_stats[key],
                                       a.shard_stats[key], rtol=1e-9)
            np.testing.assert_allclose(c.shard_stats[key],
                                       b.shard_stats[key], rtol=1e-9)
        assert np.array_equal(b.state.E, c.state.E)
        assert np.array_equal(b.state.anchor, c.state.anchor)
        assert b.n_windows == a.n_windows


def test_fig10_head_cohorts_equal_reference():
    """fig10's grid on a 2,000-request head: as many scan calls as the
    reference's cohort key gives, and every point equal to the reference
    numpy sweep."""
    from benchmarks.common import t_cg_for as ref_t_cg_for
    from benchmarks.fig10_heterogeneous import env_for as ref_env_for
    from benchmarks.fig10_heterogeneous import sized_trace as ref_sized_trace

    n_req = 2000
    pts = sweep_bench.fig10_points(n_req)
    ref_pts = []
    for size_dist in sweep_bench.SIZE_DISTS:
        rtr = ref_sized_trace("netflix", n_req, size_dist)
        for sigma in sweep_bench.PRICE_SIGMAS:
            env = RefEnv.resolve(ref_env_for(rtr, RefParams(), sigma), rtr,
                                 RefParams())
            t_cg = ref_t_cg_for(rtr, RefParams(), env=env,
                                cost_model="heterogeneous")
            for name in sweep_bench.FIG10_METHODS:
                kw = {} if name == "no_packing" else dict(t_cg=t_cg,
                                                          top_frac=1.0)
                ref_pts.append(RefSweepPoint(name, rtr, dict(
                    params=RefParams(), env=env,
                    cost_model="heterogeneous", **kw)))
    eng = SweepEngine(device="cpu")
    got = eng.run(pts)
    want = _ref_cohort_count(ref_pts)
    assert len(eng.last_stats["groups"]) == want < eng.last_n_schedules
    assert sum(g["schedules"] for g in eng.last_stats["groups"]) == \
        eng.last_n_schedules
    ref = RefSweepEngine(backend="numpy").run(ref_pts)
    for a, b in zip(ref, got):
        assert b.policy == a.policy and b.n_windows == a.n_windows
        assert_same_costs(a.costs, b.costs)
