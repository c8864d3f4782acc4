"""The port's baselines module and policy registry against the reference's.

* ``opt_lower_bound`` (a host numpy copy) equals ``repro``'s bit for bit
  under table1 and heterogeneous pricing, and refuses ``tiered`` and a
  ``params`` that disagrees with ``env.params``;
* ``run_no_packing`` / ``run_packcache2`` / ``run_dp_greedy`` with
  ``device="cpu"`` agree with the reference's numpy runs: integer
  counters exact, costs at 1e-9 relative;
* ``list_policies()`` is the reference's set, ``learned`` included.
"""
import numpy as np
import pytest

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import list_policies as ref_list_policies
from repro.core.baselines import opt_lower_bound as ref_opt
from repro.core.baselines import run_dp_greedy as ref_dp
from repro.core.baselines import run_no_packing as ref_nop
from repro.core.baselines import run_packcache2 as ref_pc
from repro.traces import SynthConfig, synth_trace

from repro_torch import list_policies
from repro_torch.convert import trace_from_arrays
from repro_torch.core import CacheEnvironment, CostParams
from repro_torch.core.baselines import (
    OPT_BOUND_MODELS,
    opt_lower_bound,
    run_dp_greedy,
    run_no_packing,
    run_packcache2,
)

PARAMS = dict(alpha=0.7, rho=2.0, omega=4, theta=0.2)
COUNTERS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
            "items_transferred")
FLOATS = ("transfer", "caching", "keepalive_rent", "total")
#: relative tolerance of a replay's float costs (the reference's own bar)
RTOL = 1e-9


@pytest.fixture(scope="module")
def traces():
    ref = synth_trace(SynthConfig(
        kind="netflix", n_items=40, n_servers=8, n_requests=1500,
        t_max=9.0, bundle_cover=1.0, bundle_zipf=0.7, seed=21,
        size_dist="lognormal"))
    port = trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)
    return ref, port


def _envs(cost_model, ref, port):
    """(reference env, port env) of one pricing model (None for table1)."""
    if cost_model == "table1":
        return None, None
    renv = RefEnv.skewed(ref.n, ref.m, RefParams(**PARAMS), price_sigma=0.8,
                         size_sigma=0.5, seed=3)
    penv = CacheEnvironment.skewed(port.n, port.m, CostParams(**PARAMS),
                                   price_sigma=0.8, size_sigma=0.5, seed=3)
    return renv, penv


@pytest.mark.parametrize("cost_model", OPT_BOUND_MODELS)
def test_opt_lower_bound_equals_reference_bitwise(traces, cost_model):
    ref, port = traces
    renv, penv = _envs(cost_model, ref, port)
    want = ref_opt(ref, RefParams(**PARAMS), env=renv,
                   cost_model=cost_model).as_dict()
    got = opt_lower_bound(port, CostParams(**PARAMS), env=penv,
                          cost_model=cost_model).as_dict()
    assert got == want


def test_opt_lower_bound_refusals(traces):
    _, port = traces
    with pytest.raises(ValueError, match="only valid"):
        opt_lower_bound(port, CostParams(**PARAMS), cost_model="tiered")
    env = CacheEnvironment(port.n, port.m, CostParams(**PARAMS))
    with pytest.raises(ValueError, match="disagree"):
        opt_lower_bound(port, CostParams(), env=env)
    # params from the environment when none are given
    assert opt_lower_bound(port, env=env).as_dict() == opt_lower_bound(
        port, CostParams(**PARAMS)).as_dict()


def _run(name, trace, params, env, cost_model, fns, **device):
    nop, pc, dp = fns
    if name == "no_packing":
        return nop(trace, params, env=env, cost_model=cost_model, **device)
    if name == "packcache":
        return pc(trace, params, t_cg=0.9, top_frac=0.5, env=env,
                  cost_model=cost_model, **device)
    return dp(trace, params, top_frac=0.5, env=env, cost_model=cost_model,
              **device)


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
@pytest.mark.parametrize("name", ["no_packing", "packcache", "dp_greedy"])
def test_run_baselines_equal_reference(traces, name, cost_model):
    ref, port = traces
    renv, penv = _envs(cost_model, ref, port)
    want = _run(name, ref, RefParams(**PARAMS), renv, cost_model,
                (ref_nop, ref_pc, ref_dp)).as_dict()
    got = _run(name, port, CostParams(**PARAMS), penv, cost_model,
               (run_no_packing, run_packcache2, run_dp_greedy),
               device="cpu").as_dict()
    for f in COUNTERS:
        assert got[f] == want[f], f
    for f in FLOATS:
        assert np.isclose(got[f], want[f], rtol=RTOL, atol=0.0), f


def test_list_policies_equals_reference():
    assert set(list_policies()) == set(ref_list_policies())
    assert "learned" in list_policies()
    assert list_policies() == sorted(list_policies())
