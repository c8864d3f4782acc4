"""The port's host-schedule replay on the CPU against the numpy engine.

``repro_torch.core.run_policy(policy, trace, device="cpu")`` must leave
the same final partition, the same ``E``/anchor float for float, the same
integer counters and costs equal at 1e-9 relative as ``repro``'s numpy
replay, for every registered policy but ``learned``, under table1, tiered
and heterogeneous pricing (per-server dt), at fixed and event-balanced
batches.  Also: the install step on tied rows, routing, and a replay
that the numpy engine stops halfway and the port finishes.
"""
import numpy as np
import pytest
import torch

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core.engine import ReplayEngine as RefReplayEngine
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.convert import (
    resume_policy,
    state_from_arrays,
    trace_from_arrays,
    window_crm_from_arrays,
)
from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    get_policy,
    run_policy,
)
from repro_torch.core.replay import TorchReplayEngine, _install_step
from repro_torch.kernels import crm_update_plain

PARAMS = dict(theta=0.2, gamma=0.85, omega=4)
T_CG = 0.61
COUNTERS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
            "items_transferred")
POLICIES = ["no_packing", "ttl", "packcache", "packcache2", "dp_greedy",
            "akpc", "akpc_no_acm", "akpc_base"]


def _policy_kw(name):
    if name == "no_packing":
        return {}
    if name == "ttl":
        return dict(t_cg=T_CG)
    if name == "dp_greedy":
        return dict(top_frac=0.5)
    return dict(t_cg=T_CG, top_frac=0.5)


@pytest.fixture(scope="module")
def traces():
    ref = ref_synth_trace(RefSynthConfig(
        kind="netflix", n_items=40, n_servers=8, n_requests=1200, t_max=6.0,
        bundle_cover=1.0, bundle_zipf=0.7, seed=11, size_dist="lognormal"))
    port = trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)
    return ref, port


def _envs(cost_model, ref, port):
    if cost_model != "heterogeneous":
        return None, None
    return (RefEnv.skewed(ref.n, ref.m, RefParams(**PARAMS), price_sigma=0.8,
                          seed=1),
            CacheEnvironment.skewed(port.n, port.m, CostParams(**PARAMS),
                                    price_sigma=0.8, seed=1))


def _ref_run(name, trace, cost_model, env, batch_size, stop=None):
    """``repro.core.run_policy`` (numpy), keeping the engine and policy."""
    pol = ref_get_policy(name, params=RefParams(**PARAMS), env=env,
                         cost_model=cost_model, **_policy_kw(name))
    pol.bind(trace.n, trace.m)
    env = RefEnv.resolve(env, trace, pol.params)
    eng = RefReplayEngine(trace.n, trace.m, pol.params, env=env,
                          cost_model=cost_model,
                          caching_charge=pol.caching_charge,
                          seed_new_cliques=pol.seed_new_cliques)
    part0 = pol.initial_partition(trace)
    if part0 is not None:
        eng.install_partition(part0, now=0.0)
    gen = pol.on_window if pol.t_cg is not None else None
    part = trace if stop is None else trace.slice(0, stop)
    eng.replay(part, clique_generator=gen, t_cg=pol.t_cg,
               batch_size=batch_size)
    return pol, eng


def _assert_state(ref_eng, state):
    rs = ref_eng.state
    assert np.array_equal(rs.partition.clique_of, state.partition.clique_of)
    assert rs.partition.cliques == state.partition.cliques
    assert np.array_equal(rs.E, state.E)                 # float for float
    assert np.array_equal(rs.anchor, state.anchor)


def _assert_costs(ref_costs, costs):
    rc, pc = ref_costs.as_dict(), costs
    for k in COUNTERS:
        assert pc[k] == rc[k], k
    for k in ("transfer", "caching", "keepalive_rent", "total"):
        assert np.isclose(pc[k], rc[k], rtol=1e-9, atol=0.0), k


@pytest.mark.parametrize("batch_size", [7, 4096, None])
@pytest.mark.parametrize("cost_model", ["table1", "tiered", "heterogeneous"])
@pytest.mark.parametrize("name", POLICIES)
def test_run_policy_matches_numpy(traces, name, cost_model, batch_size):
    ref_trace, trace = traces
    renv, env = _envs(cost_model, ref_trace, trace)
    ref_pol, ref_eng = _ref_run(name, ref_trace, cost_model, renv, batch_size)
    res = run_policy(get_policy(name, params=CostParams(**PARAMS), env=env,
                                cost_model=cost_model, **_policy_kw(name)),
                     trace, device="cpu", batch_size=batch_size)
    _assert_state(ref_eng, res.state)
    _assert_costs(ref_eng.costs, res.costs.as_dict())
    assert res.policy == ref_pol.name
    assert res.n_windows == ref_pol.n_windows
    assert len(res.size_history) == len(ref_pol.size_history)
    for a, b in zip(res.size_history, ref_pol.size_history):
        assert np.array_equal(a, b)
    host = res.loop_stats.get("path") == "host_schedule"
    assert host == (cost_model == "heterogeneous"
                    or not name.startswith("akpc"))
    if host:
        assert res.loop_stats["sync_scan"] == 0
        assert res.loop_stats["lookup_calls"] > 0


def _plain_crm_matmul(H):
    return crm_update_plain(torch.from_numpy(H)).numpy()


@pytest.mark.parametrize("cost_model", ["table1", "tiered"])
@pytest.mark.parametrize("name", ["akpc", "akpc_base"])
def test_akpc_host_path_at_uniform_dt(traces, name, cost_model):
    """A custom ``crm_matmul`` hook sends uniform-dt AKPC to the host
    clique generation (as in the reference), which must agree with the
    numpy engine as well."""
    ref_trace, trace = traces
    _, ref_eng = _ref_run(name, ref_trace, cost_model, None, 64)
    res = run_policy(get_policy(name, params=CostParams(**PARAMS),
                                cost_model=cost_model,
                                crm_matmul=_plain_crm_matmul,
                                **_policy_kw(name)),
                     trace, device="cpu", batch_size=64)
    assert res.loop_stats["path"] == "host_schedule"
    _assert_state(ref_eng, res.state)
    _assert_costs(ref_eng.costs, res.costs.as_dict())


def test_learned_raises_naming_its_slice():
    with pytest.raises(NotImplementedError, match="learned-policy slice"):
        get_policy("learned")
    with pytest.raises(KeyError, match="unknown policy"):
        get_policy("lfu")
    assert get_policy("packcache2").name == get_policy("packcache").name


def test_install_step_on_tied_rows():
    """Ties in a changed clique's member-min row: the anchor is the FIRST
    server attaining the max, as numpy's argmax (and torch's) give it."""
    m, K = 5, 4                      # 4 live rows + the dump row
    E = torch.zeros((K + 1, m), dtype=torch.float64)
    E[0] = torch.tensor([2.0, 7.0, 7.0, 1.0, 7.0])
    E[1] = torch.tensor([3.0, 7.0, 7.0, 7.0, 7.0])
    E[2] = torch.tensor([9.0, 4.0, 9.0, 9.0, 0.0])
    E[3] = torch.tensor([5.0, 5.0, 5.0, 5.0, 5.0])
    anchor = torch.tensor([1, 3, 0, 2, -1])
    i64 = torch.int64
    x = {
        "inst_mov_src": torch.tensor([3, K], dtype=i64),
        "inst_mov_dst": torch.tensor([2, K], dtype=i64),
        # new clique 0 = old rows 0 + 1; new clique 1 = old row 2 alone
        "inst_chg_rows": torch.tensor([0, 1, K], dtype=i64),
        "inst_chg_ok": torch.tensor([True, True, False]),
        "inst_chg_src": torch.tensor([0, 1, 2, 0], dtype=i64),
        "inst_chg_seg": torch.tensor([0, 0, 1, 2], dtype=i64),
        "inst_seed_j": torch.tensor([0, 0, 0], dtype=i64),
        "inst_seed_ok": torch.tensor([False, False, False]),
    }
    dt = torch.ones(m, dtype=torch.float64)
    E0 = E.clone()
    _install_step(E, anchor, x, dt, now=1.5)
    want0 = np.minimum(E0[0].numpy(), E0[1].numpy())
    want0 = np.where(want0 > 1.5, want0, 0.0)
    want1 = np.where(E0[2].numpy() > 1.5, E0[2].numpy(), 0.0)
    assert np.array_equal(E[0].numpy(), want0)
    assert np.array_equal(E[1].numpy(), want1)
    assert int(anchor[0]) == int(np.argmax(want0)) == 1
    assert int(anchor[1]) == int(np.argmax(want1)) == 0
    assert np.array_equal(E[2].numpy(), E0[3].numpy())   # moved row
    assert int(anchor[2]) == 2


def test_uniform_dt_routes_by_policy(traces):
    """At a uniform dt AKPC takes the device clique generation and the
    baselines the host schedule; per-server dt sends AKPC to the host."""
    _, trace = traces
    eng = TorchReplayEngine(trace.n, trace.m, device="cpu")
    pol = get_policy("packcache", t_cg=T_CG)
    pol.bind(trace.n, trace.m)
    eng.replay(trace, clique_generator=pol.on_window, t_cg=T_CG)
    assert eng.last_stats["path"] == "host_schedule"
    assert eng.last_stats["steps"] > 0 and eng.last_schedule.const_dt


@pytest.mark.parametrize("name,cost_model", [("ttl", "table1"),
                                             ("ttl", "heterogeneous"),
                                             ("akpc", "heterogeneous")])
def test_resume_from_numpy_state_halfway(traces, name, cost_model):
    """The numpy engine replays up to a mid-trace T_CG boundary; its state,
    the policy's window state (keep mask, or partition and previous CRM)
    and the open window go to the port, which replays the rest.  The end
    state equals one numpy run of the whole trace, and the costs add up."""
    from test_torch_slice import _boundary_requests, _boundary_walk

    ref_trace, trace = traces
    renv, env = _envs(cost_model, ref_trace, trace)
    bounds = _boundary_requests(ref_trace.times, T_CG)
    pos = bounds[len(bounds) // 2]
    win_start, next_cg = _boundary_walk(ref_trace.times, T_CG, pos)
    ref_pol, head = _ref_run(name, ref_trace, cost_model, renv, None,
                             stop=pos)
    _, full = _ref_run(name, ref_trace, cost_model, renv, None)

    pol = get_policy(name, params=CostParams(**PARAMS), env=env,
                     cost_model=cost_model, **_policy_kw(name))
    pol.bind(trace.n, trace.m)
    if name == "ttl":
        resume_policy(pol, keep=ref_pol.item_keep())
    else:
        c = ref_pol._prev_crm
        resume_policy(pol, clique_of=ref_pol._partition.clique_of,
                      prev_crm=window_crm_from_arrays(
                          c.hot_items, c.raw, c.norm, c.binary))
    env = CacheEnvironment.resolve(env, trace, pol.params)
    eng = TorchReplayEngine(trace.n, trace.m, pol.params, env=env,
                            cost_model=cost_model, device="cpu")
    st = head.state
    eng.engine.state = state_from_arrays(
        st.partition.clique_of, st.E, st.anchor, st.m)
    eng.engine._set_partition_caches(eng.engine.state.partition)
    eng.replay(trace.slice(pos, trace.n_requests),
               clique_generator=pol.on_window, t_cg=pol.t_cg,
               next_cg0=next_cg,
               win_prefix=(trace.items[win_start:pos],
                           trace.servers[win_start:pos]))
    assert eng.last_stats["path"] == "host_schedule"
    _assert_state(full, eng.state)
    costs = eng.costs.as_dict()
    hc = head.costs.as_dict()
    for k in costs:
        if k != "model":
            costs[k] += hc[k]
    costs["total"] = costs["transfer"] + costs["caching"]
    _assert_costs(full.costs, costs)
