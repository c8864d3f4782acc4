"""The sweep's device-CGM super-groups on the CPU: one laned device clique
generation against the serial runs of its points.

Each lane of a laned ``run_cgm_lanes`` (through ``SweepEngine``) must give
exactly the port's serial device-CGM replay of its point: the slot map at
every boundary element for element, ``E`` and anchors float for float,
integer cost counters exact and float costs at 1e-9, ``size_history`` and
``n_windows``.  The groups mix omega 2, 3 and 5, gammas inside and outside
the pruning regime (the full merge on), top_frac 0.5 and 1.0, a catalog
hot-set lane, prices, and ``akpc_base``.  The fig7 smoke grid's lanes
equal the reference's frozen ``cliques_ref`` oracle at every boundary;
the laned plain kernels equal the unlaned ones lane by lane, the
reference's numpy oracles and its jnp twins under ``jax.vmap``; the
split worklist's device stacks equal the unlaned worklist on oversized
partitions; ``bench/fig7.py --smoke`` passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cliques_ref
from repro.core.crm import build_window_crm as ref_build_window_crm
from repro.kernels.clique_density import clique_pair_edges_jnp
from repro.kernels.crm_update import crm_update_jnp
from repro.kernels.merge_step import merge_density_jnp
from repro.kernels.ref import clique_pair_edges_ref, crm_ref
from repro.traces import paper_trace as ref_paper_trace

from repro_torch.bench import fig7
from repro_torch.convert import trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    SweepEngine,
    SweepPoint,
    get_policy,
)
from repro_torch.core import cgm, cgm_lanes
from repro_torch.core import cliques as port_cliques
from repro_torch.core.cgm import init_cgm_carry, run_cgm_schedule
from repro_torch.core.cgm_schedule import (
    build_cgm_schedule,
    cgm_spec,
    policy_hot_dims,
)
from repro_torch.core.replay import TorchReplayEngine, run_policy_torch
from repro_torch.kernels import (
    clique_pair_edges,
    clique_pair_edges_plain,
    crm_update,
    crm_update_plain,
    merge_density,
    merge_density_plain,
)
from repro_torch.kernels.merge_step import merge_density_lanes_plain
from repro_torch.traces.synthetic import SynthConfig, synth_trace

T_CG = 0.73
INT_FIELDS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred")
FLOAT_FIELDS = ("transfer", "caching", "keepalive_rent", "total")


@pytest.fixture(scope="module")
def trace():
    return synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=12, n_requests=2000,
        t_max=20.0, bundle_cover=1.0, bundle_zipf=0.7, seed=3))


def _kw(theta=0.2, gamma=0.85, omega=5, top_frac=1.0, alpha=None,
        of_catalog=False):
    p = dict(theta=theta, gamma=gamma, omega=omega)
    if alpha is not None:
        p["alpha"] = alpha
    kw = dict(params=CostParams(**p), t_cg=T_CG, top_frac=top_frac)
    if of_catalog:
        kw["top_frac_of"] = "catalog"
    return kw


#: super-groups: (policy, lanes' knobs, the loop capacity they force)
GROUPS = {
    # omega 2 and gamma 0.6 at omega 5 lie outside the pruning regime
    "mixed_full_merge": ("akpc", [
        _kw(0.1, 0.6, 2, 0.5), _kw(0.3, 0.9, 3, 1.0), _kw(0.2, 0.6, 5, 0.5),
        _kw(0.05, 0.9, 5, 1.0), _kw(0.15, 0.85, 3, 0.5, of_catalog=True)],
        True),
    "pruned": ("akpc", [
        _kw(0.1, 0.9, 5), _kw(0.2, 0.85, 7, 0.5), _kw(0.3, 1.0, 5),
        _kw(0.05, 0.95, 3, 0.5)], False),
    "priced": ("akpc", [
        _kw(0.1, alpha=0.6), _kw(0.1, alpha=0.9), _kw(0.3, alpha=0.6)],
        False),
    "akpc_base": ("akpc_base", [
        _kw(0.05), _kw(0.2, 0.6, 3, 0.5), _kw(0.3, 0.9, 2)], False),
}


def _serial_slot_maps(name, kw, tr):
    """The port's serial device CGM of one point: its slot map at every
    boundary."""
    pol = get_policy(name, **kw)
    pol.bind(tr.n, tr.m)
    env = CacheEnvironment.resolve(None, tr, pol.params)
    jeng = TorchReplayEngine(tr.n, tr.m, pol.params, env=env, device="cpu")
    sched = build_cgm_schedule(tr, T_CG, uses_sizes=False,
                               batch_size=pol.batch_size,
                               hot_dims=policy_hot_dims(pol))
    cs = cgm_spec(pol.config, pol.config.params, tr.n)
    c0 = init_cgm_carry(jeng.engine.state, None, None, schedule=sched,
                        uses_sizes=False, item_sizes=None, device="cpu")
    _, ofs, stats = run_cgm_schedule(
        sched, jeng._spec, jeng._statics, cs, c0, None,
        enable_split=pol.config.enable_split,
        enable_acm=pol.config.enable_approx_merge)
    return ofs.numpy(), stats


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_super_group_lanes_equal_serial_runs(trace, group):
    name, kws, full_merge = GROUPS[group]
    pts = [SweepPoint(name, trace, kw) for kw in kws]
    eng = SweepEngine(device="cpu")
    got = eng.run(pts)
    assert eng.last_n_schedules == 1
    assert eng.last_stats["device_cgm_points"] == len(pts)
    (rec,) = eng.last_stats["cgm_groups"]
    assert rec["lanes"] == len(pts) and rec["full_merge"] == full_merge
    syncs = {k: 0 for k in ("sync_adjust", "sync_split", "sync_merge")}
    for kw, r, ofs in zip(kws, got, eng.last_cgm_ofs):
        want = run_policy_torch(get_policy(name, **kw), trace, device="cpu")
        serial_ofs, st = _serial_slot_maps(name, kw, trace)
        assert np.array_equal(ofs, serial_ofs)
        assert r.n_windows == want.n_windows == len(serial_ofs) >= 3
        assert np.array_equal(r.state.partition.clique_of,
                              want.state.partition.clique_of)
        assert np.array_equal(r.state.E, want.state.E)
        assert np.array_equal(r.state.anchor, want.state.anchor)
        assert len(r.size_history) == len(want.size_history)
        for a, b in zip(r.size_history, want.size_history):
            assert np.array_equal(a, b)
        assert np.array_equal(r.clique_sizes, want.clique_sizes)
        for f in INT_FIELDS:
            assert getattr(r.costs, f) == getattr(want.costs, f), f
        for f in FLOAT_FIELDS:
            assert np.isclose(getattr(r.costs, f), getattr(want.costs, f),
                              rtol=1e-9, atol=0.0), f
        for k in syncs:
            syncs[k] = max(syncs[k], st.get(k, 0))
    # a window's loop syncs are its slowest lane's: the adjust loops sync
    # twice a window like every lane, the split once
    assert rec["sync_adjust"] == syncs["sync_adjust"]
    assert rec.get("sync_split", 0) == syncs["sync_split"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_worklist_lanes_equal_unlaned(seed):
    """Oversized groups (which a sweep from singletons never makes) split
    in every lane as the unlaned worklist splits them."""
    rng = np.random.default_rng(seed)
    n, h, gcap, S = 40, 32, 16, 3
    omegas = [2, 3, 5]
    ofs, Ws, luts, gs = [], [], [], []
    for lane in range(S):
        of = rng.integers(0, 6 + lane, size=n)
        of = np.unique(of, return_inverse=True)[1].astype(np.int64)
        W = rng.random((h, h)) * (rng.random((h, h)) < 0.5)
        W = np.triu(W, 1)
        hot = np.sort(rng.choice(n, size=h - 4, replace=False))
        lut = np.full(n + 1, -1, np.int64)
        lut[hot] = np.arange(h - 4)
        ofs.append(of)
        Ws.append((W + W.T).astype(np.float32).astype(np.float64))
        luts.append(lut)
        gs.append(np.bincount(of, minlength=n))
    assert max(omegas) < max(g.max() for g in gs) <= gcap
    want = []
    for lane in range(S):
        st = {}
        want.append(cgm._split_oversized(
            torch.from_numpy(ofs[lane]), torch.from_numpy(gs[lane]),
            torch.from_numpy(Ws[lane]), torch.from_numpy(luts[lane]),
            {"omega": np.int32(omegas[lane])}, st, n=n, gcap=gcap).numpy())
    st = {}
    got = cgm_lanes._split_oversized(
        torch.from_numpy(np.stack(ofs)), torch.from_numpy(np.stack(gs)),
        torch.from_numpy(np.stack(Ws)), torch.from_numpy(np.stack(luts)),
        torch.tensor(omegas), st, n=n, gcap=gcap).numpy()
    for lane in range(S):
        assert np.array_equal(got[lane], want[lane])
        assert np.bincount(got[lane]).max() <= omegas[lane]
    assert st["split_pops"] > 0


def test_smoke_grid_equals_cliques_ref():
    """The fig7 smoke grid's lanes equal the reference's frozen
    ``cliques_ref`` oracle at every chained boundary."""
    rtr = ref_paper_trace("netflix", n_requests=fig7.SMOKE_REQUESTS)
    tr = trace_from_arrays(rtr.items, rtr.servers, rtr.times, rtr.n, rtr.m)
    t_cg = fig7.t_cg_for(tr, CostParams())
    combos = [(th, g, om) for th in fig7.SMOKE_THETAS
              for g in fig7.SMOKE_GAMMAS for om in fig7.SMOKE_OMEGAS]
    pts = [SweepPoint("akpc", tr, dict(
        params=CostParams(theta=th, gamma=g, omega=om), t_cg=t_cg,
        top_frac=fig7.SMOKE_TOP_FRAC)) for th, g, om in combos]
    eng = SweepEngine(device="cpu")
    eng.run(pts)
    assert eng.last_n_schedules == 1
    for (th, g, om), ofs in zip(combos, eng.last_cgm_ofs):
        times, R = rtr.times, rtr.n_requests
        next_cg = float(times[0]) + t_cg
        win_start = pos = 0
        prev = prev_crm = None
        want = []
        while pos < R:
            cut = int(np.searchsorted(times, next_cg, side="left"))
            if cut <= pos:
                crm = ref_build_window_crm(rtr.items[win_start:pos], rtr.n,
                                           th, top_frac=fig7.SMOKE_TOP_FRAC)
                prev = cliques_ref.generate_cliques(prev, prev_crm, crm,
                                                    rtr.n, om, g)
                want.append(prev.clique_of.copy())
                prev_crm = crm
                win_start = pos
                while next_cg <= float(times[pos]):
                    next_cg += t_cg
                continue
            pos = cut
        assert len(want) == len(ofs) >= 3
        for w, o in zip(want, ofs):
            assert np.array_equal(o, w)


def test_fig7_smoke_passes_on_cpu():
    assert fig7.smoke("cpu") == 0


def test_fig7_grid_is_four_super_groups():
    """The whole fig7 grid (both traces, three axes, two methods) runs as
    4 super-groups of 17 lanes, one schedule each, no host CGM call."""
    traces = {}
    for k in fig7.KINDS:
        rtr = ref_paper_trace(k, n_requests=1200)
        traces[k] = trace_from_arrays(rtr.items, rtr.servers, rtr.times,
                                      rtr.n, rtr.m)
    pts, keys = fig7.grid_points(traces)
    assert len(pts) == 68 and len(set(keys)) == 34
    eng = SweepEngine(device="cpu")
    before = port_cliques.CGM_CALLS
    res = eng.run(pts)
    assert port_cliques.CGM_CALLS == before
    assert eng.last_n_schedules == 4
    assert [g["lanes"] for g in eng.last_stats["cgm_groups"]] == [17] * 4
    assert all(r.loop_stats["path"] == "sweep_cgm_lanes" for r in res)


# ---------------------------------------------------------------------------
# the laned plain kernels
# ---------------------------------------------------------------------------
def _lanes_inputs(seed, S=3, rows=97, h=40, k=24):
    rng = np.random.default_rng(seed)
    H = (rng.random((S, rows, h)) < 0.1).astype(np.float32)
    A = rng.random((S, h, h)) < 0.3
    A = np.triu(A, 1)
    A = (A | A.transpose(0, 2, 1)).astype(np.float32)
    M = np.zeros((S, k, h), np.float32)
    for lane in range(S):
        grp = rng.integers(-1, k - lane * 5, size=h)
        M[lane, grp[grp >= 0], np.arange(h)[grp >= 0]] = 1.0
    X = M @ A @ M.transpose(0, 2, 1)
    sizes = M.sum(2).astype(np.int32)
    return H, M, A, X.astype(np.float32), sizes


@pytest.mark.parametrize("seed", [0, 1])
def test_laned_crm_and_pair_edges_plain(seed):
    H, M, A, _, _ = _lanes_inputs(seed)
    got_c = crm_update(torch.from_numpy(H)).numpy()
    got_x = clique_pair_edges(torch.from_numpy(M), torch.from_numpy(A)).numpy()
    with jax.enable_x64(True):
        twin_c = np.asarray(jax.vmap(crm_update_jnp)(jnp.asarray(H)))
        twin_x = np.asarray(jax.vmap(clique_pair_edges_jnp)(
            jnp.asarray(M), jnp.asarray(A)))
        for lane in range(H.shape[0]):
            assert np.array_equal(
                got_c[lane], crm_update_plain(torch.from_numpy(H[lane])).numpy())
            assert np.array_equal(got_c[lane],
                                  np.asarray(crm_ref(jnp.asarray(H[lane]))))
            assert np.array_equal(got_x[lane], clique_pair_edges_plain(
                torch.from_numpy(M[lane]), torch.from_numpy(A[lane])).numpy())
            assert np.array_equal(got_x[lane], np.asarray(
                clique_pair_edges_ref(jnp.asarray(M[lane]),
                                      jnp.asarray(A[lane]))))
    assert np.array_equal(got_c, twin_c)
    assert np.array_equal(got_x, twin_x)


@pytest.mark.parametrize("n_act", [None, [24, 5, 0], [1, 24, 13]])
def test_laned_merge_density_plain(n_act):
    _, _, _, X, sizes = _lanes_inputs(7)
    omegas = np.array([2, 3, 5], np.int32)
    gammas = np.array([0.6, 0.85, 0.0], np.float32)
    acts = None if n_act is None else torch.tensor(n_act)
    got = merge_density(torch.from_numpy(X), torch.from_numpy(sizes),
                        torch.from_numpy(omegas), torch.from_numpy(gammas),
                        n_act=acts).numpy()
    assert np.array_equal(got, merge_density_lanes_plain(
        torch.from_numpy(X), torch.from_numpy(sizes),
        torch.from_numpy(omegas), torch.from_numpy(gammas), acts).numpy())
    with jax.enable_x64(True):
        twin = np.asarray(jax.vmap(merge_density_jnp)(
            jnp.asarray(X), jnp.asarray(sizes), jnp.asarray(omegas),
            jnp.asarray(gammas)))
    S = X.shape[1]
    for lane in range(X.shape[0]):
        k = None if n_act is None else n_act[lane]
        want = merge_density_plain(
            torch.from_numpy(X[lane]), torch.from_numpy(sizes[lane]),
            int(omegas[lane]), float(gammas[lane]), n_act=k).numpy()
        assert np.array_equal(got[lane], want)
        if k is None:
            assert np.array_equal(got[lane], twin[lane])
        else:
            act = np.arange(S) < k
            actp = act[:, None] & act[None, :] & ~np.eye(S, dtype=bool)
            assert np.array_equal(got[lane], np.where(actp, twin[lane], -2.0))
    assert (got >= 0.0).any()
