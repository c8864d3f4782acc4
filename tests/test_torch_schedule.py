"""The port's host-built replay schedule against the JAX package's.

``repro_torch.core.schedule.build_schedule`` / ``pad_schedule`` must give
the same padded step tensors as ``repro.core.engine_jax``'s, key by key
and array for array (``build_schedule`` is host numpy in both packages,
so this runs on the CPU although the JAX device scan does not), under
table1, tiered and heterogeneous pricing, with the TTL policy's ``nokeep``
mask, and with fixed and event-balanced batches.
"""
import numpy as np
import pytest

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import engine_jax as ref_ej
from repro.core import get_policy as ref_get_policy
from repro.core.engine import ReplayEngine as RefReplayEngine
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.convert import trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    ReplayEngine,
    get_policy,
)
from repro_torch.core import schedule as sched

PARAMS = dict(theta=0.2, gamma=0.85, omega=4)
TRACE = dict(kind="netflix", n_items=40, n_servers=8, n_requests=1200,
             t_max=6.0, bundle_cover=1.0, bundle_zipf=0.7, seed=11,
             size_dist="lognormal")
POLICY_KW = {"akpc": dict(t_cg=0.61, top_frac=0.5), "ttl": dict(t_cg=0.61),
             "no_packing": {}}


@pytest.fixture(scope="module")
def traces():
    ref = ref_synth_trace(RefSynthConfig(**TRACE))
    port = trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)
    return ref, port


def _envs(cost_model, ref, port):
    if cost_model != "heterogeneous":
        return (RefEnv.from_trace(ref, RefParams(**PARAMS)),
                CacheEnvironment.from_trace(port, CostParams(**PARAMS)))
    renv = RefEnv.skewed(ref.n, ref.m, RefParams(**PARAMS), price_sigma=0.8,
                         seed=1)
    env = CacheEnvironment.skewed(port.n, port.m, CostParams(**PARAMS),
                                  price_sigma=0.8, seed=1)
    return (RefEnv.resolve(renv, ref, renv.params),
            CacheEnvironment.resolve(env, port, env.params))


def _both(name, cost_model, traces, batch_size, *, slice_=None, **kw):
    ref, port = traces
    if slice_ is not None:
        ref, port = ref.slice(*slice_), port.slice(*slice_)
    renv, env = _envs(cost_model, ref, port)
    rpol = ref_get_policy(name, params=RefParams(**PARAMS),
                          **POLICY_KW[name])
    pol = get_policy(name, params=CostParams(**PARAMS), **POLICY_KW[name])
    rpol.bind(ref.n, ref.m)
    pol.bind(port.n, port.m)
    reng = RefReplayEngine(ref.n, ref.m, renv.params, env=renv,
                           cost_model=cost_model)
    eng = ReplayEngine(port.n, port.m, env.params, env=env,
                       cost_model=cost_model)
    rgen = rpol.on_window if rpol.t_cg is not None else None
    gen = pol.on_window if pol.t_cg is not None else None
    want = ref_ej.build_schedule(
        reng.state.partition, ref, rgen, rpol.t_cg, model=reng.model,
        env=renv, batch_size=batch_size, **kw)
    got = sched.build_schedule(
        eng.state.partition, port, gen, pol.t_cg, model=eng.model, env=env,
        batch_size=batch_size, **kw)
    return got, want


def _same_schedule(got, want):
    for f in ("n", "m", "nb", "ne", "const_dt", "uses_sizes", "n_requests",
              "n_item_requests", "win_start", "boundary_hit", "next_cg",
              "nrow", "ncol"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.xs.keys() == want.xs.keys()
    for k, v in want.xs.items():
        assert got.xs[k].dtype == v.dtype, k
        assert np.array_equal(got.xs[k], v), k
    assert np.array_equal(got.final_partition.clique_of,
                          want.final_partition.clique_of)
    assert sched.schedule_dims(got) == ref_ej.schedule_dims(want)


@pytest.mark.parametrize("batch_size", [7, 4096, None])
@pytest.mark.parametrize("cost_model", ["table1", "tiered", "heterogeneous"])
@pytest.mark.parametrize("name", ["akpc", "ttl", "no_packing"])
def test_build_schedule_equal(traces, name, cost_model, batch_size):
    got, want = _both(name, cost_model, traces, batch_size)
    _same_schedule(got, want)
    assert got.const_dt == (cost_model != "heterogeneous")
    assert ("nokeep" in got.xs) == (name == "ttl")
    if name == "akpc":
        assert got.xs["inst"].any()


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
def test_pad_schedule_equal(traces, cost_model):
    got, want = _both("akpc", cost_model, traces, 64)
    dims = dict(ref_ej.schedule_dims(want))
    dims = {k: v + (8 if k != "nb" else 4) for k, v in dims.items()}
    _same_schedule(sched.pad_schedule(got, dims),
                   ref_ej.pad_schedule(want, dims))
    assert sched.pad_schedule(got, sched.schedule_dims(got)) is got


def test_build_schedule_resumes_open_window(traces):
    """``next_cg0`` and ``win_prefix``: a resumed walk with an open
    window of earlier requests."""
    ref, port = traces
    kw = dict(next_cg0=float(ref.times[600]) + 0.2,
              win_prefix=(ref.items[500:600], ref.servers[500:600]))
    got, want = _both("akpc", "heterogeneous", traces, None,
                      slice_=(600, 1200), **kw)
    _same_schedule(got, want)


def test_build_schedule_progress_calls(traces):
    """``progress(pos)`` fires at the reference's positions (the first
    batch, then once per 64Ki requests)."""
    ref, port = traces
    eng = ReplayEngine(port.n, port.m, CostParams(**PARAMS))
    reng = RefReplayEngine(ref.n, ref.m, RefParams(**PARAMS))
    got, want = [], []
    sched.build_schedule(eng.state.partition, port, None, None,
                         model=eng.model, env=eng.env, batch_size=7,
                         progress=got.append)
    ref_ej.build_schedule(reng.state.partition, ref, None, None,
                          model=reng.model, env=reng.env, batch_size=7,
                          progress=want.append)
    assert got == want == [7]
