"""The replay's item -> clique lookup: one call a partition stretch.

``repro_torch.core.schedule.build_schedule`` looks up the clique ids of a
whole stretch of requests (from one T_CG boundary to the next) in one
call of its ``lookup`` hook and hands each batch its slice.  The schedule
must stay array for array equal to ``repro.core.engine_jax``'s (a host
function in both packages, which runs on the CPU), the hook must be
called once a stretch, and :class:`~repro_torch.kernels.packed_lookup.
CliqueLookup` must answer for the ``clique_of`` it is given, even one
changed in place, with -1 pads kept.
"""
import numpy as np
import pytest
import torch

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import engine_jax as ref_ej
from repro.core import get_policy as ref_get_policy
from repro.core.engine import ReplayEngine as RefReplayEngine
from repro.kernels.packed_lookup import clique_lookup as ref_clique_lookup
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.convert import trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CostParams,
    ReplayEngine,
    get_policy,
)
from repro_torch.core import replay as port_replay
from repro_torch.core import schedule as sched
from repro_torch.core.engine import _numpy_clique_lookup
from repro_torch.kernels.packed_lookup import CliqueLookup, clique_lookup

PARAMS = dict(theta=0.2, gamma=0.85, omega=4)
#: 1,500 requests over 6 time units: about ten T_CG windows at t_cg 0.61
TRACE = dict(kind="netflix", n_items=40, n_servers=8, n_requests=1500,
             t_max=6.0, bundle_cover=1.0, bundle_zipf=0.7, seed=23,
             size_dist="lognormal")
POLICY_KW = {"akpc": dict(t_cg=0.61, top_frac=0.5), "ttl": dict(t_cg=0.61),
             "packcache": dict(t_cg=0.61, top_frac=0.5), "no_packing": {}}


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


def _build(name, cost_model, traces, batch_size, lookup):
    """The reference's schedule and the port's, built with ``lookup``."""
    ref, port = traces
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
        env=renv, batch_size=batch_size)
    got = sched.build_schedule(
        eng.state.partition, port, gen, pol.t_cg, model=eng.model, env=env,
        batch_size=batch_size, lookup=lookup)
    return got, want, pol


def _same_schedule(got, want):
    for f in ("n", "m", "nb", "ne", "const_dt", "uses_sizes", "n_requests",
              "n_item_requests", "win_start", "boundary_hit", "next_cg"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.xs.keys() == want.xs.keys()
    for k, v in want.xs.items():
        assert got.xs[k].dtype == v.dtype, k
        assert np.array_equal(got.xs[k], v), k
    assert np.array_equal(got.final_partition.clique_of,
                          want.final_partition.clique_of)


def _stretches(times, t_cg) -> int:
    """Stretches of requests under one partition: the T_CG walk's windows
    that hold a request (one stretch without clique generation)."""
    if t_cg is None:
        return 1
    next_cg, k = float(times[0]) + t_cg, 1
    for t in times:
        if t >= next_cg:
            k += 1
            while next_cg <= t:
                next_cg += t_cg
    return k


@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
@pytest.mark.parametrize("batch_size", [7, 4096, None])
@pytest.mark.parametrize("name", ["akpc", "no_packing", "ttl", "packcache"])
def test_stretch_lookup_keeps_schedule(traces, name, batch_size, cost_model):
    """One lookup a partition stretch, through ``CliqueLookup`` on the CPU,
    gives the reference's schedule array for array."""
    look = CliqueLookup("cpu")
    got, want, pol = _build(name, cost_model, traces, batch_size, look)
    _same_schedule(got, want)
    stretches = _stretches(traces[1].times, pol.t_cg)
    assert look.calls == stretches
    assert stretches == (1 if pol.t_cg is None else pol.n_windows + 1)
    if pol.t_cg is not None:
        assert stretches >= 8
    # every valid item slot is looked up once, in one of the calls
    assert look.bytes_up == 4 * int((traces[1].items >= 0).sum())
    assert look.table_uploads <= look.calls


@pytest.mark.parametrize("batch_size", [7, None])
@pytest.mark.parametrize("name", ["akpc", "no_packing"])
def test_default_lookup_keeps_schedule(traces, name, batch_size):
    """The host gather (``build_schedule``'s default lookup) runs through
    the same per-stretch code."""
    calls = []

    def counted(clique_of, items):
        calls.append(np.asarray(items).size)
        return _numpy_clique_lookup(clique_of, items)

    got, want, pol = _build(name, "heterogeneous", traces, batch_size,
                            counted)
    _same_schedule(got, want)
    assert len(calls) == _stretches(traces[1].times, pol.t_cg)
    default, _, _ = _build(name, "heterogeneous", traces, batch_size, None)
    _same_schedule(default, want)


def test_host_schedule_counts_one_lookup_a_stretch(traces):
    """``build_host_schedule`` reports the lookups' calls, seconds, bytes
    and table uploads of one build."""
    _, port = traces
    pol = get_policy("akpc", params=CostParams(**PARAMS),
                     **POLICY_KW["akpc"])
    pol.bind(port.n, port.m)
    env = CacheEnvironment.from_trace(port, CostParams(**PARAMS))
    eng = ReplayEngine(port.n, port.m, env.params, env=env)
    look = CliqueLookup("cpu")
    _, stats = port_replay.build_host_schedule(
        eng.state.partition, port, pol.on_window, pol.t_cg, model=eng.model,
        env=env, lookup=look)
    assert stats["lookup_calls"] == pol.n_windows + 1
    assert stats["lookup_bytes_up"] == stats["lookup_bytes_down"] == \
        4 * int((port.items >= 0).sum())
    assert 1 <= stats["lookup_table_uploads"] <= stats["lookup_calls"]
    assert stats["lookup_table_bytes_up"] == \
        4 * port.n * stats["lookup_table_uploads"]
    assert stats["lookup_s"] >= 0.0


@pytest.mark.parametrize("n,shape", [(60, (500, 5)), (10_000, (4096,)),
                                     (1, (3, 2))])
def test_clique_lookup_keeps_pads(n, shape):
    """-1 pads stay -1, through ``CliqueLookup`` and the host gather, as
    in the reference's ``clique_lookup``."""
    rng = np.random.default_rng(n + 1)
    clique_of = rng.permutation(n).astype(np.int32)
    items = rng.integers(-1, n, size=shape)
    items.reshape(-1)[0] = -1
    want = ref_clique_lookup(clique_of, items)
    for got in (CliqueLookup("cpu")(clique_of, items),
                clique_lookup(clique_of, items, device="cpu"),
                _numpy_clique_lookup(clique_of, items)):
        assert got.shape == items.shape
        assert np.array_equal(got, want)
        assert (got[items < 0] == -1).all()


def test_clique_lookup_follows_a_changed_table():
    """A new ``clique_of``, or the same array changed in place, is uploaded
    again and answered; an unchanged one is not uploaded again."""
    rng = np.random.default_rng(3)
    clique_of = rng.permutation(500).astype(np.int64)
    items = rng.integers(-1, 500, size=(300, 4))
    look = CliqueLookup("cpu")
    for _ in range(2):
        assert np.array_equal(look(clique_of, items),
                              ref_clique_lookup(clique_of, items))
    assert look.table_uploads == 1 and look.table_bytes_up == 4 * 500
    clique_of[:] = clique_of[::-1].copy()          # changed in place
    assert np.array_equal(look(clique_of, items),
                          ref_clique_lookup(clique_of, items))
    fresh = rng.permutation(700).astype(np.int32)  # a new, larger table
    wide = rng.integers(-1, 700, size=(50, 3))
    assert np.array_equal(look(fresh, wide), ref_clique_lookup(fresh, wide))
    assert look.table_uploads == 3
    assert look.calls == 4
    st = look.stats()
    assert st["lookup_table_uploads"] == 3
    assert st["lookup_table_bytes_up"] == 4 * (500 + 500 + 700)
    assert st["lookup_bytes_up"] == st["lookup_bytes_down"] == \
        4 * (3 * items.size + wide.size)


def test_clique_lookup_refuses_ids_outside_catalog_and_empty():
    look = CliqueLookup("cpu")
    with pytest.raises(IndexError):
        look(np.arange(5), np.array([0, 5]))
    got = look(np.arange(5), np.zeros((0, 3), np.int64))
    assert got.shape == (0, 3)


@pytest.mark.parametrize("make", [
    lambda: clique_lookup(np.arange(4), np.array([0, 1])),
    lambda: CliqueLookup(),
])
def test_lookup_without_device_needs_cuda(monkeypatch, make):
    """With no device, the lookup resolves to CUDA like every entry point
    of the port, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
