"""The port's competitive machinery and the rest of ``repro.core``'s public
names, on the CPU, against the reference.

The contracts of ``tests/test_competitive.py``: the Thm-2 adversary
realises the corrected bound exactly on the device replay, the
generalized bound reduces to the corrected and the env bounds, and the
per-request checks stay <= 1 on random traces under table1 and
heterogeneous pricing.  The per-request values (each request's transfer,
caching charge on missed cliques and missed items, read from the device
replay's per-step record) equal the reference's ``handle_request`` loop
request for request.  Every name of ``repro.core`` / ``repro.traces``
that the port exports behaves as its counterpart on a small trace; and
the ``paper_literal`` cost mode replays as the reference's numpy engine
does, on the device CGM and on the host schedule.
"""
import math

import numpy as np
import pytest

import repro.core as ref_core
import repro.traces as ref_traces
from repro.core import CacheEnvironment as RefEnv
from repro.core import CliquePartition as RefPartition
from repro.core import CostParams as RefParams
from repro.core import ReplayEngine as RefReplayEngine

import repro_torch.core as core
from repro_torch.core import policy as policy_module
import repro_torch.traces as traces
from repro_torch.bench.common import t_cg_for
from repro_torch.convert import env_from_arrays, trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CliquePartition,
    CostParams,
    adversarial_trace,
    competitive_bound,
    competitive_bound_corrected,
    competitive_bound_env,
    generalized_bound,
    generalized_per_request_ratio_check,
    per_request_ratio_check,
    replay_adversary,
)
from repro_torch.core.competitive import request_outcomes

#: repro.core names whose counterpart carries another name in the port,
#: and the one it has not (its host engine has no handle_batch)
RENAMED = {"JAX_COST_MODELS": "DEVICE_COST_MODELS",
           "JaxReplayEngine": "TorchReplayEngine",
           "run_policy_jax": "run_policy_torch"}
ABSENT = {"BatchOutcome"}


def _groups_of_five(n=60):
    return [tuple(range(i, i + 5)) for i in range(0, n, 5)]


def _both_traces(seed, n_requests=1500, kind="netflix"):
    ref = ref_traces.paper_trace(kind, n_requests=n_requests, seed=seed)
    return ref, trace_from_arrays(ref.items, ref.servers, ref.times, ref.n,
                                  ref.m, sizes=ref.sizes)


def _both_envs(n, m, seed, price_sigma=0.6, size_sigma=0.3, **params):
    renv = RefEnv.skewed(n, m, RefParams(**params), price_sigma=price_sigma,
                         size_sigma=size_sigma, seed=seed)
    return renv, env_from_arrays(n, m, CostParams(**params), renv.lam_j,
                                 renv.mu_j, renv.item_sizes)


# ---------------------------------------------------------------------------
# Thm 2: the adversary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,omega", [(1, 5), (2, 5), (5, 5), (3, 8), (1, 2)])
def test_adversary_realises_bound_exactly(S, omega):
    params = CostParams(omega=omega)
    setup = adversarial_trace(S=S, omega=omega, n_phases=7, params=params)
    akpc, opt, bound = replay_adversary(setup, params, device="cpu")
    assert math.isclose(akpc / opt, bound, rel_tol=1e-12)
    rp = RefParams(omega=omega)
    want = ref_core.replay_adversary(
        ref_core.adversarial_trace(S=S, omega=omega, n_phases=7, params=rp),
        rp)
    assert np.allclose((akpc, opt, bound), want, rtol=1e-12, atol=0.0)
    assert np.array_equal(setup.trace.items, ref_core.adversarial_trace(
        S=S, omega=omega, n_phases=7, params=rp).trace.items)


@pytest.mark.parametrize("S,omega,alpha", [(1, 2, 0.1), (4, 6, 1.0),
                                           (3, 3, 0.45), (2, 6, 0.7)])
def test_adversary_ratio_under_bound(S, omega, alpha):
    params = CostParams(omega=omega, alpha=alpha)
    setup = adversarial_trace(S=S, omega=omega, n_phases=3, params=params)
    akpc, opt, bound = replay_adversary(setup, params, device="cpu")
    assert akpc / opt <= bound + 1e-9


def test_adversary_heterogeneous_equals_reference():
    """Under a skewed environment OPT is priced by the model's hooks and
    the bound is the env bound, as in the reference."""
    S, omega = 3, 4
    params = CostParams(omega=omega)
    setup = adversarial_trace(S=S, omega=omega, n_phases=5, params=params)
    n, m = setup.trace.n, setup.trace.m
    renv, env = _both_envs(n, m, seed=2, omega=omega)
    got = replay_adversary(setup, params, env=env,
                           cost_model="heterogeneous", device="cpu")
    rp = RefParams(omega=omega)
    want = ref_core.replay_adversary(
        ref_core.adversarial_trace(S=S, omega=omega, n_phases=5, params=rp),
        rp, env=renv, cost_model="heterogeneous")
    assert np.allclose(got, want, rtol=1e-12, atol=0.0)
    assert got[0] / got[1] <= got[2] + 1e-9


# ---------------------------------------------------------------------------
# the generalized bound
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,omega", [(1, 1), (1, 5), (2, 5), (5, 3)])
def test_generalized_bound_reduces_to_corrected(S, omega):
    params = CostParams(rho=1.0)
    env = CacheEnvironment(30, 6, params)
    got = generalized_bound(env, S, omega, "table1")
    assert math.isclose(got, competitive_bound_corrected(S, omega,
                                                         params.alpha),
                        rel_tol=1e-12)
    assert got == ref_core.generalized_bound(RefEnv(30, 6, RefParams(
        rho=1.0)), S, omega, "table1")


@pytest.mark.parametrize("S,omega", [(1, 3), (3, 3), (4, 1)])
def test_generalized_bound_reduces_to_env_bound(S, omega):
    params = CostParams(rho=2.5)
    env = CacheEnvironment.skewed(30, 6, params, price_sigma=0.7,
                                  size_sigma=0.4, seed=3)
    got = generalized_bound(env, S, omega, "heterogeneous")
    assert math.isclose(got, competitive_bound_env(env, S, omega),
                        rel_tol=1e-12)
    renv = RefEnv.skewed(30, 6, RefParams(rho=2.5), price_sigma=0.7,
                         size_sigma=0.4, seed=3)
    assert got == ref_core.generalized_bound(renv, S, omega,
                                             "heterogeneous")


def test_generalized_bound_rejects_degenerate_args():
    env = CacheEnvironment(10, 2, CostParams())
    with pytest.raises(ValueError):
        generalized_bound(env, 0, 3)
    with pytest.raises(ValueError):
        generalized_bound(env, 2, 0)
    with pytest.raises(ValueError):
        competitive_bound(0, 3, 0.5)


# ---------------------------------------------------------------------------
# Thm 1 request by request
# ---------------------------------------------------------------------------
def _ref_outcomes(rtr, rpart, params, env=None, cost_model="table1"):
    eng = RefReplayEngine(rtr.n, rtr.m, params, caching_charge="requested",
                          seed_new_cliques=False, env=env,
                          cost_model=cost_model)
    eng.install_partition(rpart, now=0.0)
    outs = [eng.handle_request(rtr.items[i], int(rtr.servers[i]),
                               float(rtr.times[i]))
            for i in range(rtr.n_requests)]
    return (np.array([o.transfer for o in outs]),
            np.array([o.caching_miss for o in outs]),
            np.array([o.n_missed_items for o in outs]))


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_request_outcomes_equal_handle_request(cost_model):
    """Each request's transfer, caching charge on missed cliques and
    missed items from the device replay's per-step record equal the
    reference's ``handle_request`` loop, request for request."""
    rtr, tr = _both_traces(seed=5, n_requests=800)
    renv = env = None
    if cost_model == "heterogeneous":
        renv, env = _both_envs(tr.n, tr.m, seed=6)
    part = CliquePartition.from_cliques(60, _groups_of_five())
    rpart = RefPartition.from_cliques(60, _groups_of_five())
    transfer, caching_miss, missed, _ = request_outcomes(
        tr, part, CostParams(), env, cost_model, device="cpu")
    want = _ref_outcomes(rtr, rpart, RefParams(), renv, cost_model)
    assert np.array_equal(missed, want[2])
    assert missed.sum() > 0 and (missed == 0).sum() > 0
    np.testing.assert_allclose(transfer, want[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(caching_miss, want[1], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 17, 58])
def test_per_request_bound_on_random_traces(seed):
    """Thm 1 (corrected) holds request by request, with the reference's
    worst slack."""
    rtr, tr = _both_traces(seed)
    part = CliquePartition.from_cliques(60, _groups_of_five())
    worst = per_request_ratio_check(tr, part, CostParams(), device="cpu")
    assert 0.0 < worst <= 1.0 + 1e-9
    want = ref_core.per_request_ratio_check(
        rtr, RefPartition.from_cliques(60, _groups_of_five()), RefParams())
    assert math.isclose(worst, want, rel_tol=1e-9)


@pytest.mark.parametrize("seed", [1, 42])
def test_generalized_per_request_bound_table1(seed):
    rtr, tr = _both_traces(seed)
    part = CliquePartition.from_cliques(60, _groups_of_five())
    worst = generalized_per_request_ratio_check(tr, part, CostParams(),
                                                device="cpu")
    assert 0.0 < worst <= 1.0 + 1e-9
    want = ref_core.generalized_per_request_ratio_check(
        rtr, RefPartition.from_cliques(60, _groups_of_five()), RefParams())
    assert math.isclose(worst, want, rel_tol=1e-9)


@pytest.mark.parametrize("seed", [3, 29])
def test_generalized_per_request_bound_heterogeneous(seed):
    rtr, tr = _both_traces(seed, n_requests=1000)
    renv, env = _both_envs(tr.n, tr.m, seed=seed + 1)
    part = CliquePartition.from_cliques(60, _groups_of_five())
    worst = generalized_per_request_ratio_check(
        tr, part, CostParams(), env=env, cost_model="heterogeneous",
        device="cpu")
    assert 0.0 < worst <= 1.0 + 1e-9
    want = ref_core.generalized_per_request_ratio_check(
        rtr, RefPartition.from_cliques(60, _groups_of_five()), RefParams(),
        env=renv, cost_model="heterogeneous")
    assert math.isclose(worst, want, rel_tol=1e-9)


# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------
def test_every_reference_name_has_a_counterpart():
    mine = set(core.__all__)
    for name in ref_core.__all__:
        if name in ABSENT:
            continue
        assert RENAMED.get(name, name) in mine, name
        assert hasattr(core, RENAMED.get(name, name))
    assert set(traces.__all__) == set(ref_traces.__all__)


def test_registries_and_bounds_equal_reference():
    assert core.list_cost_models() == ref_core.list_cost_models()
    assert core.list_policies() == sorted(
        set(ref_core.list_policies()) | {"learned"})
    for S, om, a in ((1, 5, 0.8), (4, 3, 0.6), (7, 9, 1.0)):
        assert core.competitive_bound(S, om, a) == \
            ref_core.competitive_bound(S, om, a)
        assert core.competitive_bound_corrected(S, om, a) == \
            ref_core.competitive_bound_corrected(S, om, a)
    renv, env = _both_envs(20, 4, seed=9)
    assert core.competitive_bound_env(env, 3, 4) == \
        ref_core.competitive_bound_env(renv, 3, 4)


def test_register_policy_adds_a_factory(monkeypatch):
    # a copy of the registry for this test alone: a name left registered
    # would reach every later test in the worker (list_policies parity)
    monkeypatch.setattr(policy_module, "_REGISTRY",
                        dict(policy_module._REGISTRY))
    name = "test_torch_competitive_np"
    if name not in core.list_policies():
        core.register_policy(name)(
            lambda **kw: core.NoPackingPolicy(**kw))
    assert isinstance(core.get_policy(name), core.NoPackingPolicy)
    assert isinstance(core.get_policy(name), core.CachePolicy)
    with pytest.raises(ValueError, match="already registered"):
        core.register_policy(name)(core.NoPackingPolicy)


def test_run_akpc_shims_equal_reference():
    rtr, tr = _both_traces(seed=2, n_requests=2500)
    span = float(tr.times[-1] - tr.times[0])
    got = core.run_akpc(tr, core.AKPCConfig(t_cg=span / 10, top_frac=1.0),
                        device="cpu")
    want = ref_core.run_akpc(rtr, ref_core.AKPCConfig(t_cg=span / 10,
                                                      top_frac=1.0))
    assert isinstance(got, core.AKPCResult)
    assert got.n_windows == want.n_windows
    assert np.array_equal(np.sort(got.clique_sizes),
                          np.sort(want.clique_sizes))
    assert math.isclose(got.total, want.total, rel_tol=1e-9)
    got = core.run_akpc_variant(tr, CostParams(), split=False,
                                approx_merge=False, t_cg=span / 10,
                                top_frac=1.0, device="cpu")
    want = ref_core.run_akpc_variant(rtr, RefParams(), split=False,
                                     approx_merge=False, t_cg=span / 10,
                                     top_frac=1.0)
    assert got.costs.n_misses == want.costs.n_misses
    assert math.isclose(got.total, want.total, rel_tol=1e-9)


def test_trace_batch_helpers_equal_reference():
    rtr, tr = _both_traces(seed=4, n_requests=1001)
    for bs in (1, 64, 4096):
        a, b = traces.batch_tensors(tr, bs), ref_traces.batch_tensors(rtr, bs)
        for f in ("times", "servers", "items", "lengths"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_batches, a.batch_size, a.n_requests) == \
            (b.n_batches, b.batch_size, b.n_requests)
        for x, y in zip(traces.iter_batch_tensors(tr, bs),
                        ref_traces.iter_batch_tensors(rtr, bs)):
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
        assert [t.n_requests for t in traces.iter_batches(tr, bs)] == \
            [t.n_requests for t in ref_traces.iter_batches(rtr, bs)]
    for (e1, w1), (e2, w2) in zip(traces.iter_windows(tr, 0.7),
                                  ref_traces.iter_windows(rtr, 0.7)):
        assert e1 == e2 and np.array_equal(w1.items, w2.items)
    a = traces.paper_trace_batches("spotify", 700, seed=1, batch_size=128)
    b = ref_traces.paper_trace_batches("spotify", 700, seed=1, batch_size=128)
    assert np.array_equal(a.items, b.items) and a.name == b.name
    cfg = dict(kind="netflix", n_items=30, n_servers=4, n_requests=300,
               seed=8)
    a = traces.synth_trace_batches(traces.SynthConfig(**cfg), 50)
    b = ref_traces.synth_trace_batches(ref_traces.SynthConfig(**cfg), 50)
    assert np.array_equal(a.times, b.times)


def test_host_helpers_equal_reference():
    """The exported host pieces the port copied: clique generation, the
    window CRM, batch events and partition matching."""
    rtr, tr = _both_traces(seed=6, n_requests=400)
    crm = core.build_window_crm(tr.items, 60, 0.2, top_frac=1.0)
    rcrm = ref_core.build_window_crm(rtr.items, 60, 0.2, top_frac=1.0)
    assert np.array_equal(crm.raw, rcrm.raw)
    assert np.array_equal(crm.binary, rcrm.binary)
    part = core.generate_cliques(None, None, crm, 60, 5, 0.5)
    rpart = ref_core.generate_cliques(None, None, rcrm, 60, 5, 0.5)
    assert np.array_equal(part.clique_of, rpart.clique_of)
    it, sv, ts = tr.items[:50], tr.servers[:50], tr.times[:50]
    ev = core.batch_events(part.k, tr.m, it, sv, ts,
                           part.clique_of[it[it >= 0]], None)
    rev = ref_core.batch_events(rpart.clique_of, rpart.k, rtr.m, it, sv, ts,
                                lambda of, items: of[items], None)
    assert ev.n_events == rev.n_events > 0
    for f in ("ev_c", "ev_j", "ev_t", "first_cj", "prev_cj_t"):
        assert np.array_equal(getattr(ev, f), getattr(rev, f)), f
    other = CliquePartition.from_cliques(60, _groups_of_five())
    got = core.match_partitions(part, other)
    want = ref_core.match_partitions(
        rpart, RefPartition.from_cliques(60, _groups_of_five()))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert core.DEFAULT_BATCH_SIZE == ref_core.DEFAULT_BATCH_SIZE
    assert core.greedy_pair_matching is not None


# ---------------------------------------------------------------------------
# cost_mode="paper_literal" (Alg. 5 line 11 as written)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["netflix", "spotify"])
@pytest.mark.parametrize("name", ["akpc", "akpc_base", "no_packing"])
@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_paper_literal_equals_reference(kind, name, cost_model):
    """The literal pseudocode pricing on a 6,000-request head: table1 on
    the device clique generation (AKPC), heterogeneous on the host
    schedule; the port's replay equals the reference's numpy run at
    1e-9."""
    rtr, tr = _both_traces(seed=3, n_requests=6000, kind=kind)
    params = CostParams(cost_mode="paper_literal")
    rparams = RefParams(cost_mode="paper_literal")
    renv = env = None
    if cost_model == "heterogeneous":
        renv = RefEnv.skewed(tr.n, tr.m, rparams, price_sigma=0.5,
                             size_sigma=0.5, seed=3)
        env = env_from_arrays(tr.n, tr.m, params, renv.lam_j, renv.mu_j,
                              renv.item_sizes)
    t_cg = t_cg_for(tr, params, env=env, cost_model=cost_model)
    kw = {} if name == "no_packing" else dict(t_cg=t_cg, top_frac=1.0)
    got = core.run_policy(core.get_policy(
        name, params=params, env=env, cost_model=cost_model, **kw), tr,
        device="cpu")
    want = ref_core.run_policy(ref_core.get_policy(
        name, params=rparams, env=renv, cost_model=cost_model, **kw), rtr,
        backend="numpy")
    if name != "no_packing":     # the path each pricing is meant to take
        if cost_model == "table1":
            assert "sync_adjust" in got.loop_stats      # device CGM
        else:
            assert got.loop_stats["path"] == "host_schedule"
    for f in ("n_misses", "n_hits", "items_transferred", "n_requests"):
        assert getattr(got.costs, f) == getattr(want.costs, f), f
    for f in ("transfer", "caching", "keepalive_rent"):
        assert math.isclose(getattr(got.costs, f), getattr(want.costs, f),
                            rel_tol=1e-9, abs_tol=1e-9), f
    assert np.array_equal(np.sort(got.clique_sizes),
                          np.sort(want.clique_sizes))
