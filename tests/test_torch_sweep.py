"""The port's scenario-lane sweep on the CPU against the reference's.

The bar is the reference's own (``tests/test_sweep.py``), held against
the oracle that runs on this tree, ``repro``'s ``SweepEngine(backend=
"numpy")`` (its serial numpy loop): every point of the port's lane-stacked
sweep has the same integer cost counters and float costs at 1e-9, for
every shareable policy (and ``ttl``) under table1 and heterogeneous
pricing, with schedules shared along the alpha axis and not across CGM
axes, device-CGM super-group points, and trace shards.  Below the engine:
the scans' lane form equals the per-lane scans and ``jax.vmap`` of the
reference's jnp twins, a laned ``run_schedule`` equals one unlaned run
per lane, and cohort padding changes nothing.  The refusals (backend,
mesh, row_sharded layout, cost model) raise; a ``learned`` point sweeps like its
serial run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.sweep_bench import build_grid as ref_build_grid
from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import SweepEngine as RefSweepEngine
from repro.core import SweepPoint as RefSweepPoint
from repro.core.engine_jax import fresh_state_arrays as ref_fresh_state
from repro.core.engine_jax import pad_spec_cols as ref_pad_spec_cols
from repro.kernels.segment_reduce import (
    seg_running_argmax_jnp,
    seg_running_max_jnp,
)
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import paper_trace as ref_paper_trace
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
    run_policy,
    sweep_points,
)
from repro_torch.core.cost import CostModel, register_cost_model
from repro_torch.core.replay import (
    cost_spec,
    fresh_state_arrays,
    pad_spec_cols,
    run_schedule,
)
from repro_torch.core.schedule import build_schedule, pad_schedule, schedule_dims
from repro_torch.core.sweep import SHAREABLE_POLICIES
from repro_torch.kernels import (
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
)

T_CG = 0.73
TOP_FRAC = 1.0
INT_FIELDS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred")
FLOAT_FIELDS = ("transfer", "caching", "keepalive_rent", "total")
POLICIES = (*SHAREABLE_POLICIES, "ttl")


def _kw(name):
    if name in ("packcache", "akpc", "akpc_no_acm", "akpc_base"):
        return dict(t_cg=T_CG, top_frac=TOP_FRAC)
    if name == "ttl":
        return dict(t_cg=T_CG)
    if name == "dp_greedy":
        return dict(top_frac=TOP_FRAC)
    return {}


def _traces(n_requests=3000, seed=3, m=12, size_dist="unit"):
    ref = ref_synth_trace(RefSynthConfig(
        kind="netflix", n_items=60, n_servers=m, n_requests=n_requests,
        t_max=30.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed,
        size_dist=size_dist))
    port = trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)
    return ref, port


def assert_same_costs(ref, got):
    a = ref.as_dict() if not isinstance(ref, dict) else ref
    b = got.as_dict() if not isinstance(got, dict) else got
    for f in INT_FIELDS:
        assert a[f] == b[f], f"{f}: {a[f]} != {b[f]}"
    for f in FLOAT_FIELDS:
        assert np.isclose(a[f], b[f], rtol=1e-9, atol=1e-9), \
            f"{f}: {a[f]} != {b[f]}"


class Scenario:
    """One pricing scenario on both sides: the reference's CostParams and
    (price-only) environment, and the port's, from the same arrays."""

    def __init__(self, params: dict, ref_trace, port_trace,
                 price_sigma=None, cost_model="table1"):
        self.cost_model = cost_model
        self.ref_params = RefParams(**params)
        self.port_params = CostParams(**params)
        self.ref_env = self.port_env = None
        if price_sigma is not None:
            self.ref_env = RefEnv.skewed(ref_trace.n, ref_trace.m,
                                         self.ref_params,
                                         price_sigma=price_sigma, seed=1)
            self.port_env = env_from_arrays(
                port_trace.n, port_trace.m, self.port_params,
                self.ref_env.lam_j, self.ref_env.mu_j)

    def kwargs(self, name, side, **extra):
        kw = dict(_kw(name), cost_model=self.cost_model, **extra)
        if side == "ref":
            kw.update(params=self.ref_params, env=self.ref_env)
        else:
            kw.update(params=self.port_params, env=self.port_env)
        return kw


def _both(specs):
    """(ref points, port points) for (policy, scenario, ref trace, port
    trace, extra kwargs) tuples."""
    ref_pts, port_pts = [], []
    for name, sc, rt, pt, extra in specs:
        ref_pts.append(RefSweepPoint(name, rt, sc.kwargs(name, "ref", **extra)))
        port_pts.append(SweepPoint(name, pt, sc.kwargs(name, "port", **extra)))
    return ref_pts, port_pts


def _check(ref_res, got_res):
    for a, b in zip(ref_res, got_res):
        assert b.policy == a.policy
        assert b.n_windows == a.n_windows
        assert b.costs.model == a.costs.model
        assert np.array_equal(np.sort(b.clique_sizes), np.sort(a.clique_sizes))
        assert_same_costs(a.costs, b.costs)


@pytest.fixture(scope="module")
def unit_traces():
    return _traces()


@pytest.fixture(scope="module")
def sized_traces():
    return _traces(size_dist="lognormal")


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_sweep_matches_reference_all_policies(unit_traces, sized_traces,
                                              cost_model):
    """Every shareable policy and ttl at two alphas (two lanes a shared
    schedule) equal the reference's serial numpy sweep; under per-server
    dt the lanes' final state equals the port's serial runs."""
    hetero = cost_model == "heterogeneous"
    rt, pt = sized_traces if hetero else unit_traces
    scen = [Scenario(dict(alpha=a), rt, pt,
                     price_sigma=0.8 if hetero else None,
                     cost_model=cost_model) for a in (0.6, 0.9)]
    ref_pts, port_pts = _both([(name, sc, rt, pt, {}) for name in POLICIES
                               for sc in scen])
    eng = SweepEngine(device="cpu")
    got = eng.run(port_pts)
    _check(RefSweepEngine(backend="numpy").run(ref_pts), got)
    # a shareable policy's two alphas share a schedule; ttl never shares;
    # one scan a cohort: the shareable policies' schedules, and ttl's two
    # (their step tensors add "nokeep")
    assert eng.last_n_schedules == len(SHAREABLE_POLICIES) + 2
    assert sorted((g["lanes"], g["members"], g["schedules"])
                  for g in eng.last_stats["groups"]) == \
        [(2, 2, 2), (2 * len(SHAREABLE_POLICIES), len(SHAREABLE_POLICIES),
                     len(SHAREABLE_POLICIES))]
    if hetero:
        serial = SweepEngine(backend="serial", device="cpu").run(port_pts)
        for a, b in zip(serial, got):
            assert np.array_equal(a.state.partition.clique_of,
                                  b.state.partition.clique_of)
            assert np.array_equal(a.state.E, b.state.E)
            assert np.array_equal(a.state.anchor, b.state.anchor)
            assert_same_costs(a.costs, b.costs)


def test_sweep_matches_reference_tiered(sized_traces):
    rt, pt = sized_traces
    scen = [Scenario(dict(alpha=a), rt, pt, cost_model="tiered")
            for a in (0.7, 1.0)]
    ref_pts, port_pts = _both([("akpc", sc, rt, pt, {}) for sc in scen])
    eng = SweepEngine(device="cpu")
    _check(RefSweepEngine(backend="numpy").run(ref_pts), eng.run(port_pts))
    assert eng.last_n_schedules == 1


def test_sweep_shares_schedules_across_alpha_axis(unit_traces):
    """An alpha sweep runs clique generation once and still matches the
    per-point serial replays (alpha never enters the CGM)."""
    rt, pt = unit_traces
    scen = [Scenario(dict(alpha=a), rt, pt) for a in (0.6, 0.8, 1.0)]
    ref_pts, port_pts = _both([("akpc", sc, rt, pt, {}) for sc in scen])
    eng = SweepEngine(device="cpu")
    got = eng.run(port_pts)
    assert eng.last_n_schedules == 1
    assert eng.last_stats["groups"][0]["lanes"] == 3
    _check(RefSweepEngine(backend="numpy").run(ref_pts), got)
    assert len({round(r.total, 6) for r in got}) == 3


def test_sweep_does_not_share_across_cgm_axes(unit_traces):
    """theta changes the CGM: separate schedules, results still match."""
    rt, pt = unit_traces
    scen = [Scenario(dict(theta=th), rt, pt) for th in (0.1, 0.3)]
    ref_pts, port_pts = _both([("packcache", sc, rt, pt, {}) for sc in scen])
    eng = SweepEngine(device="cpu")
    got = eng.run(port_pts)
    assert eng.last_n_schedules == 2
    _check(RefSweepEngine(backend="numpy").run(ref_pts), got)


def test_device_cgm_super_group_points(unit_traces):
    """AKPC points that differ in two CGM keys under a uniform dt are the
    reference's device-CGM super-group; the port replays them as the lanes
    of one laned device clique generation (one schedule), with the
    reference's results."""
    rt, pt = unit_traces
    scen = [Scenario(dict(theta=th), rt, pt) for th in (0.1, 0.3)]
    ref_pts, port_pts = _both([("akpc", sc, rt, pt, {}) for sc in scen])
    eng = SweepEngine(device="cpu")
    got = eng.run(port_pts)
    assert eng.last_stats["device_cgm_points"] == 2
    assert eng.last_stats["schedules"] == 0
    assert eng.last_n_schedules == 1
    (rec,) = eng.last_stats["cgm_groups"]
    assert rec["lanes"] == 2 and rec["windows"] == got[0].n_windows
    assert rec["sync_adjust"] == 2 * rec["windows"]
    assert all(r.loop_stats["path"] == "sweep_cgm_lanes" for r in got)
    _check(RefSweepEngine(backend="numpy").run(ref_pts), got)


def test_sweep_shard_axis_matches_reference():
    """A sharded point merges per-shard costs exactly and reports the
    reference's per-shard totals; one schedule per shard."""
    pairs = [_traces(n_requests=1200, seed=s) for s in (3, 4, 5)]
    rts = [p[0] for p in pairs]
    pts_ = [p[1] for p in pairs]
    ref_pts, port_pts = [], []
    for a in (0.7, 0.9):
        sc = Scenario(dict(alpha=a), rts[0], pts_[0])
        ref_pts.append(RefSweepPoint("akpc", rts, sc.kwargs("akpc", "ref")))
        port_pts.append(SweepPoint("akpc", pts_, sc.kwargs("akpc", "port")))
    eng = SweepEngine(device="cpu")
    got = eng.run(port_pts)
    assert eng.last_n_schedules == len(pairs)
    ref = RefSweepEngine(backend="numpy").run(ref_pts)
    for a, b in zip(ref, got):
        assert_same_costs(a.costs, b.costs)
        assert b.shard_stats["n"] == 3
        np.testing.assert_allclose(b.shard_stats["totals"],
                                   a.shard_stats["totals"], rtol=1e-9)
        np.testing.assert_allclose(b.shard_stats["ci95"],
                                   a.shard_stats["ci95"], rtol=1e-9)
    serial = SweepEngine(backend="serial", device="cpu").run(port_pts)
    for a, b in zip(serial, got):
        assert_same_costs(a.costs, b.costs)
        assert a.shard_stats["totals"] == pytest.approx(
            b.shard_stats["totals"], rel=1e-9)
    plain = SweepEngine(device="cpu").run([SweepPoint(
        "akpc", pts_[0], dict(params=CostParams(), **_kw("akpc")))])[0]
    assert plain.shard_stats is None


@pytest.mark.parametrize("name", ["no_packing", "packcache", "akpc"])
def test_policy_batch_size_as_serial(unit_traces, name):
    """A point's batch size comes from its policy, as in a serial run: a
    policy batch of 7 requests gives the serial run's state and costs and
    the reference's, and its points share no schedule with the default
    batching."""
    rt, pt = unit_traces
    scen = [Scenario(dict(alpha=a), rt, pt) for a in (0.6, 0.9)]
    ref_pts, port_pts = _both([(name, sc, rt, pt, dict(batch_size=bs))
                               for bs in (7, None) for sc in scen])
    eng = SweepEngine(device="cpu")
    got = eng.run(port_pts)
    # two schedules (batch 7 and the default), one cohort: one scan
    assert [(g["lanes"], g["members"], g["schedules"])
            for g in eng.last_stats["groups"]] == [(4, 2, 2)]
    _check(RefSweepEngine(backend="numpy").run(ref_pts), got)
    serial = SweepEngine(backend="serial", device="cpu").run(port_pts)
    for a, b in zip(serial, got):
        assert np.array_equal(a.state.E, b.state.E)
        assert np.array_equal(a.state.anchor, b.state.anchor)
        assert_same_costs(a.costs, b.costs)


def test_sweep_points_convenience(unit_traces):
    _, pt = unit_traces
    grid = [dict(policy="no_packing", trace=pt,
                 policy_kwargs={"params": CostParams()})]
    a = sweep_points(grid, backend="serial", device="cpu")[0]
    b = sweep_points(grid, device="cpu")[0]
    assert_same_costs(a.costs, b.costs)


def test_refusals(unit_traces):
    _, pt = unit_traces
    for backend in ("jax", "numpy", "tpu-magic"):
        with pytest.raises(ValueError, match="unknown sweep backend"):
            SweepEngine(backend=backend, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
        SweepEngine(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
        SweepEngine(layout="row_sharded", device="cpu")
    assert SweepEngine(layout="bucketed", device="cpu").layout.kind == \
        "bucketed"
    # ``learned`` was refused before it was ported; it now sweeps like a
    # serial run (its warm start: the TTL baseline's decisions)
    kw = dict(params=CostParams(), t_cg=T_CG)
    (res,) = SweepEngine(device="cpu").run([SweepPoint("learned", pt, kw)])
    want = run_policy(get_policy("learned", **kw), pt, device="cpu")
    assert res.costs.as_dict() == want.costs.as_dict()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SweepEngine()


def test_inexpressible_cost_model_refused(unit_traces):
    """A custom cost model has no device formula: both backends raise."""

    class WeirdModel(CostModel):
        name = "weird_sweep_model"
        uses_sizes = False

        def dt(self):
            return np.full(self.env.m, self.params.dt)

    from repro_torch.core import cost as port_cost

    if "weird_sweep_model" not in port_cost._COST_MODELS:
        register_cost_model("weird_sweep_model")(WeirdModel)
    _, pt = unit_traces
    pts = [SweepPoint("no_packing", pt, dict(
        params=CostParams(), cost_model="weird_sweep_model"))]
    for backend in ("torch", "serial"):
        with pytest.raises(NotImplementedError, match="no device formula"):
            SweepEngine(backend=backend, device="cpu").run(pts)


# ---------------------------------------------------------------------------
# below the engine: lane scans, laned run_schedule, padding, helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("L", [1, 7, 1000])
def test_lane_scans_equal_per_lane_and_vmapped_twins(S, L):
    rng = np.random.default_rng(S * 1000 + L)
    v = rng.integers(0, 4, size=(S, L)).astype(np.float64)
    v[rng.random((S, L)) < 0.1] = -np.inf
    s = rng.random(L) < 0.05
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    got_max = seg_running_max(tv, ts)
    got_v, got_i = seg_running_argmax(tv, ts)
    assert got_max.shape == (S, L) and got_i.dtype == torch.int32
    for i in range(S):
        assert torch.equal(got_max[i], seg_running_max_plain(tv[i], ts))
        lv, li = seg_running_argmax_plain(tv[i], ts)
        assert torch.equal(got_v[i], lv) and torch.equal(got_i[i], li)
    with jax.enable_x64(True):
        vm = jax.vmap(seg_running_max_jnp, in_axes=(0, None))(
            jnp.asarray(v), jnp.asarray(s))
        va, ia = jax.vmap(seg_running_argmax_jnp, in_axes=(0, None))(
            jnp.asarray(v), jnp.asarray(s))
    assert np.array_equal(got_max.numpy(), np.asarray(vm))
    assert np.array_equal(got_v.numpy(), np.asarray(va))
    assert np.array_equal(got_i.numpy(), np.asarray(ia))


def _hetero_schedule(pt, sc, name="akpc"):
    pol = get_policy(name, **sc.kwargs(name, "port"))
    pol.bind(pt.n, pt.m)
    env = CacheEnvironment.resolve(pol.env, pt, pol.params)
    model = get_cost_model("heterogeneous", env)
    sched = build_schedule(pol.initial_partition(pt) or _singletons(pt.n),
                           pt, pol.on_window, pol.t_cg, model=model, env=env)
    return sched, cost_spec(model, env)


def _singletons(n):
    from repro_torch.core.cliques import CliquePartition

    return CliquePartition.singletons(n)


def test_laned_run_schedule_equals_unlaned_per_lane(sized_traces):
    """One laned scan over 3 pricing scenarios equals 3 unlaned scans:
    E and anchor bitwise, costs at 1e-12."""
    rt, pt = sized_traces
    scen = [Scenario(dict(alpha=a), rt, pt, price_sigma=sg,
                     cost_model="heterogeneous")
            for a, sg in ((0.6, 0.8), (0.8, 0.3), (1.0, 1.0))]
    sched, _ = _hetero_schedule(pt, scen[0])
    specs = [_hetero_schedule(pt, sc, "no_packing")[1][0] for sc in scen]
    statics = ("heterogeneous", False, 0)
    E0, a0 = fresh_state_arrays(pt.n, pt.m)
    lane_spec = {k: np.stack([sp[k] for sp in specs]) for k in specs[0]}
    EL, AL, accL = run_schedule(
        sched, lane_spec, statics, torch.from_numpy(np.stack([E0] * 3)),
        torch.from_numpy(np.stack([a0] * 3)))
    assert accL.shape == (3, 6)
    for i, sp in enumerate(specs):
        E1, A1, acc1 = run_schedule(sched, sp, statics,
                                    torch.from_numpy(E0.copy()),
                                    torch.from_numpy(a0.copy()))
        assert torch.equal(EL[i], E1) and torch.equal(AL[i], A1)
        np.testing.assert_allclose(accL[i].numpy(), acc1.numpy(),
                                   rtol=1e-12, atol=0.0)


def test_cohort_padding_writes_only_the_dump_row(sized_traces):
    """A schedule padded to larger dims (more steps, events and install
    slots) leaves every lane's live state and costs as they were."""
    rt, pt = sized_traces
    scen = [Scenario(dict(alpha=a), rt, pt, price_sigma=0.8,
                     cost_model="heterogeneous") for a in (0.6, 1.0)]
    sched, (spec0, statics) = _hetero_schedule(pt, scen[0])
    spec1 = _hetero_schedule(pt, scen[1])[1][0]
    dims = {k: v + 5 for k, v in schedule_dims(sched).items()}
    padded = pad_schedule(sched, dims)
    assert padded.nb == sched.nb + 5
    lane_spec = {k: np.stack([spec0[k], spec1[k]]) for k in spec0}
    E0, a0 = fresh_state_arrays(pt.n, pt.m)
    outs = []
    for s in (sched, padded):
        outs.append(run_schedule(
            s, lane_spec, statics, torch.from_numpy(np.stack([E0] * 2)),
            torch.from_numpy(np.stack([a0] * 2))))
    (Ea, Aa, acca), (Eb, Ab, accb) = outs
    K = pt.n
    assert torch.equal(Ea[:, :K], Eb[:, :K])
    assert torch.equal(Aa[:, :K], Ab[:, :K])
    np.testing.assert_allclose(acca.numpy(), accb.numpy(), rtol=1e-12)


def test_state_and_spec_helpers_equal_reference():
    E0, a0 = fresh_state_arrays(7, 3)
    rE, ra = ref_fresh_state(7, 3)
    assert np.array_equal(E0, rE) and np.array_equal(a0, ra)
    spec = {"dt": np.array([[1.0, 2.0], [3.0, 4.0]]),
            "lam_j": np.array([0.5, 0.7]), "mu_j": np.array([1.0, 2.0]),
            "alpha": np.float64(0.8)}
    got, want = pad_spec_cols(spec, 5), ref_pad_spec_cols(spec, 5)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k])


def test_fig6_grid_equals_reference():
    """sweep_bench's fig6 grid: the reference's points (tags, t_cg) and,
    on a short trace, its parity check against the serial loop."""
    rtr = ref_paper_trace("netflix", n_requests=3000, seed=0)
    ptr = trace_from_arrays(rtr.items, rtr.servers, rtr.times, rtr.n, rtr.m)
    ref = ref_build_grid(rtr, 3, 2)
    got = sweep_bench.build_grid(ptr, 3, 2)
    assert [p.tag for p in got] == [p.tag for p in ref]
    assert [p.policy_kwargs["t_cg"] for p in got] == \
        [p.policy_kwargs["t_cg"] for p in ref]
    swept = SweepEngine(device="cpu").run(got)
    sweep_bench.assert_parity(got, RefSweepEngine(backend="numpy").run(ref),
                              swept)


def test_fig10_points_equal_reference_scenarios():
    """fig10's grid: the same traces, prices and t_cg as the reference's
    ``run_grid`` would sweep, and the sweep equals the serial loop."""
    from benchmarks.common import t_cg_for as ref_t_cg_for
    from benchmarks.fig10_heterogeneous import env_for as ref_env_for
    from benchmarks.fig10_heterogeneous import sized_trace as ref_sized_trace

    pts = sweep_bench.fig10_points(2000)
    assert len(pts) == 18
    i = 0
    for size_dist in ("unit", "lognormal"):
        rtr = ref_sized_trace("netflix", 2000, size_dist)
        assert np.array_equal(sweep_bench.sized_trace(2000, size_dist).items,
                              rtr.items)
        for sigma in (0.0, 0.5, 1.0):
            env = RefEnv.resolve(ref_env_for(rtr, RefParams(), sigma), rtr,
                                 RefParams())
            t_cg = ref_t_cg_for(rtr, RefParams(), env=env,
                                cost_model="heterogeneous")
            for _ in range(3):
                pt = pts[i]
                assert np.array_equal(pt.trace.items, rtr.items)
                penv = pt.policy_kwargs["env"]
                assert np.array_equal(penv.lam_per_server(),
                                      env.lam_per_server())
                assert np.array_equal(penv.sizes(), env.sizes())
                if "t_cg" in pt.policy_kwargs:
                    assert pt.policy_kwargs["t_cg"] == t_cg
                i += 1
    swept = SweepEngine(device="cpu").run(pts)
    serial = SweepEngine(backend="serial", device="cpu").run(pts)
    sweep_bench.assert_parity(pts, serial, swept)
