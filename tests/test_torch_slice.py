"""The port's AKPC replay on the CPU against the numpy engine of ``repro``.

``repro_torch``'s device replay (clique generation included) must leave
the same final partition, the same ``E``/anchor float for float, the same
integer counters and costs equal at 1e-9 relative as
``repro.core.run_policy(..., backend="numpy")``, for every AKPC variant,
under table1 and tiered pricing, at batch sizes 7 and 4096.  A resume
case hands the numpy engine's state and the policy's previous CRM to the
port halfway through the trace, through ``repro_torch.convert``.
"""
import numpy as np
import pytest

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core import run_policy as ref_run_policy
from repro.core.engine import ReplayEngine as RefReplayEngine
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.convert import (
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
from repro_torch.core.replay import TorchReplayEngine

T_CG = 0.61
KW = dict(t_cg=T_CG, top_frac=0.5)
PARAMS = dict(theta=0.2, gamma=0.85, omega=4)
COUNTERS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
            "items_transferred")


def _trace_kw(cost_model):
    kw = dict(kind="netflix", n_items=40, n_servers=8, n_requests=1200,
              t_max=6.0, bundle_cover=1.0, bundle_zipf=0.7, seed=11)
    if cost_model == "tiered":
        kw["size_dist"] = "lognormal"
    return kw


@pytest.fixture(scope="module", params=["table1", "tiered"])
def traces(request):
    ref = ref_synth_trace(RefSynthConfig(**_trace_kw(request.param)))
    port = trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)
    return request.param, ref, port


def _ref_engine(name, trace, cost_model, batch_size, stop=None):
    pol = ref_get_policy(name, params=RefParams(**PARAMS), **KW,
                         cost_model=cost_model)
    pol.bind(trace.n, trace.m)
    env = RefEnv.resolve(None, trace, pol.params)
    eng = RefReplayEngine(trace.n, trace.m, pol.params, env=env,
                          cost_model=cost_model)
    part = trace if stop is None else trace.slice(0, stop)
    eng.replay(part, clique_generator=pol.on_window, t_cg=pol.t_cg,
               batch_size=batch_size)
    return pol, eng


def _port_engine(name, trace, cost_model):
    pol = get_policy(name, params=CostParams(**PARAMS), **KW,
                     cost_model=cost_model)
    pol.bind(trace.n, trace.m)
    env = CacheEnvironment.resolve(None, trace, pol.params)
    eng = TorchReplayEngine(trace.n, trace.m, pol.params, env=env,
                            cost_model=cost_model, device="cpu")
    return pol, eng


def _assert_same(ref_eng, port_eng, head_costs=None):
    rs, ps = ref_eng.state, port_eng.state
    assert np.array_equal(rs.partition.clique_of, ps.partition.clique_of)
    assert rs.partition.cliques == ps.partition.cliques
    assert np.array_equal(rs.E, ps.E)                 # float for float
    assert np.array_equal(rs.anchor, ps.anchor)
    rc = ref_eng.costs.as_dict()
    pc = port_eng.costs.as_dict()
    if head_costs is not None:
        for k in pc:
            if k != "model":
                pc[k] += head_costs[k]
        pc["total"] = pc["transfer"] + pc["caching"]
    for k in COUNTERS:
        assert pc[k] == rc[k], k
    for k in ("transfer", "caching", "keepalive_rent", "total"):
        assert np.isclose(pc[k], rc[k], rtol=1e-9, atol=0.0), k


@pytest.mark.parametrize("batch_size", [7, 4096])
@pytest.mark.parametrize("name", ["akpc", "akpc_no_acm", "akpc_base"])
def test_replay_matches_numpy_engine(traces, name, batch_size):
    cost_model, ref_trace, trace = traces
    _, ref_eng = _ref_engine(name, ref_trace, cost_model, batch_size)
    pol, eng = _port_engine(name, trace, cost_model)
    eng.replay(trace, clique_generator=pol.on_window, t_cg=pol.t_cg,
               batch_size=batch_size)
    _assert_same(ref_eng, eng)
    assert ref_eng.state.partition.k < trace.n        # cliques did form


def test_run_policy_matches_numpy_run_policy(traces):
    cost_model, ref_trace, trace = traces
    ref = ref_run_policy(
        ref_get_policy("akpc", params=RefParams(**PARAMS), **KW,
                       cost_model=cost_model), ref_trace, backend="numpy")
    res = run_policy(get_policy("akpc", params=CostParams(**PARAMS), **KW,
                                cost_model=cost_model), trace, device="cpu")
    assert res.policy == ref.policy
    assert res.n_windows == ref.n_windows
    assert np.array_equal(res.clique_sizes, ref.clique_sizes)
    assert len(res.size_history) == len(ref.size_history)
    for a, b in zip(res.size_history, ref.size_history):
        assert np.array_equal(a, b)
    for k in COUNTERS:
        assert getattr(res.costs, k) == getattr(ref.costs, k), k
    assert np.isclose(res.total, ref.total, rtol=1e-9, atol=0.0)


def _boundary_walk(times, t_cg, upto):
    """(win_start, next_cg) just before the boundary at request ``upto``
    fires, walking the T_CG grid as the replay does."""
    next_cg = float(times[0]) + t_cg
    win_start = pos = 0
    while pos < upto:
        cut = int(np.searchsorted(times, next_cg, side="left"))
        if cut <= pos:
            t = float(times[pos])
            win_start = pos
            while next_cg <= t:
                next_cg += t_cg
            continue
        pos = min(cut, upto)
    return win_start, next_cg


def _boundary_requests(times, t_cg):
    """Request indices at which a T_CG boundary fires."""
    next_cg = float(times[0]) + t_cg
    out, pos = [], 0
    while pos < times.shape[0]:
        cut = int(np.searchsorted(times, next_cg, side="left"))
        if cut <= pos:
            out.append(pos)
            while next_cg <= float(times[pos]):
                next_cg += t_cg
            continue
        pos = cut
    return out


@pytest.mark.parametrize("name", ["akpc", "akpc_no_acm"])
def test_resume_from_numpy_state_halfway(traces, name):
    """The numpy engine replays up to a mid-trace T_CG boundary; its state,
    the policy's previous CRM and the open window go to the port, which
    replays the rest.  The end state equals one numpy run of the whole
    trace, and the costs add up to it."""
    cost_model, ref_trace, trace = traces
    bounds = _boundary_requests(ref_trace.times, T_CG)
    pos = bounds[len(bounds) // 2]
    win_start, next_cg = _boundary_walk(ref_trace.times, T_CG, pos)
    ref_pol, head = _ref_engine(name, ref_trace, cost_model, None, stop=pos)
    _, full = _ref_engine(name, ref_trace, cost_model, None)

    pol, eng = _port_engine(name, trace, cost_model)
    st = head.state
    eng.engine.state = state_from_arrays(
        st.partition.clique_of, st.E, st.anchor, st.m)
    eng.engine._set_partition_caches(eng.engine.state.partition)
    c = ref_pol._prev_crm
    pol._prev_crm = window_crm_from_arrays(c.hot_items, c.raw, c.norm,
                                           c.binary)
    eng.replay(trace.slice(pos, trace.n_requests),
               clique_generator=pol.on_window, t_cg=pol.t_cg,
               next_cg0=next_cg,
               win_prefix=(trace.items[win_start:pos],
                           trace.servers[win_start:pos]))
    _assert_same(full, eng, head_costs=head.costs.as_dict())
