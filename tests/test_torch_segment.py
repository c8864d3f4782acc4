"""The port's scan and gather kernels' plain versions against the JAX package.

On the CPU the wrappers ``seg_running_max`` / ``seg_running_argmax`` /
``seg_scan_step`` / ``packed_lookup`` run their plain versions.  Those
must equal the Pallas kernels run in interpret mode (under
``jax.enable_x64``) and the numpy oracles ``seg_running_*_ref`` bit for
bit: the scans only select values, the gather only copies, and the step's
operands ``t + dt[lane, j]`` are formed in numpy for the references.
Shapes are ragged (L on both sides of the replay's 8192) with tie-heavy
values and -inf entries; ``clique_lookup`` must equal the reference's,
padding slots included.  A heterogeneous host-schedule replay on the CPU
calls ``seg_scan_step`` once a step and equals the numpy engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed_lookup import clique_lookup as ref_clique_lookup
from repro.kernels.packed_lookup import packed_lookup as pallas_packed_lookup
from repro.kernels.segment_reduce import seg_running_argmax as pallas_argmax
from repro.kernels.segment_reduce import seg_running_argmax_ref
from repro.kernels.segment_reduce import seg_running_max as pallas_max
from repro.kernels.segment_reduce import seg_running_max_ref
from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core.engine import ReplayEngine as RefReplayEngine
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.convert import trace_from_arrays
from repro_torch.core import CacheEnvironment, CostParams, get_policy, run_policy
from repro_torch.kernels import (
    packed_lookup,
    packed_lookup_plain,
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
    seg_scan_step,
    seg_scan_step_plain,
)
from repro_torch.core import schedule as schedule_mod
from repro_torch.kernels import segment_reduce
from repro_torch.kernels.packed_lookup import CliqueLookup, clique_lookup

LENGTHS = [1, 7, 8191, 8193]
STARTS = ["all", "first", "p0.01", "p0.5", "none"]


def _starts(rng, L, starts):
    if starts == "all":
        return np.ones(L, bool)
    if starts == "first":
        s = np.zeros(L, bool)
        s[0] = True
        return s
    if starts == "none":            # position 0 starts a segment regardless
        return np.zeros(L, bool)
    return rng.random(L) < float(starts[1:])


def _inputs(L, starts, seed):
    """Values drawn from a few integers (ties everywhere) plus -inf."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 4, size=L).astype(np.float64)
    v[rng.random(L) < 0.1] = -np.inf
    return v, _starts(rng, L, starts)


def _step_inputs(S, L, starts, seed, m=5):
    """``seg_scan_step``'s arguments as numpy: two scans' (L,) times, half
    from a few multiples of 0.5 (ties in t + dt everywhere) and half
    continuous (sums that round), with -inf entries, int64 server ids in
    [0, m) and start flags, then a (S, m) dt, half multiples of 0.5."""
    rng = np.random.default_rng(seed)

    def half_continuous(a, scale):
        cont = rng.random(a.shape) < 0.5
        a[cont] = rng.random(int(cont.sum())) * scale
        return a

    out = []
    for _ in range(2):
        t = half_continuous(rng.integers(0, 4, size=L) * 0.5, 4.0)
        t[rng.random(L) < 0.1] = -np.inf
        out += [t, rng.integers(0, m, size=L), _starts(rng, L, starts)]
    return (*out, half_continuous(rng.integers(1, 3, size=(S, m)) * 0.5, 1.0))


def _hetero_trace():
    """A small trace in both packages' forms, for the heterogeneous
    replays."""
    ref = ref_synth_trace(RefSynthConfig(
        kind="netflix", n_items=40, n_servers=8, n_requests=1500, t_max=6.0,
        bundle_cover=1.0, bundle_zipf=0.7, seed=5, size_dist="lognormal"))
    return ref, trace_from_arrays(ref.items, ref.servers, ref.times, ref.n,
                                  ref.m, sizes=ref.sizes)


def _hetero_policy(name, trace, **kw):
    return get_policy(name, params=CostParams(), env=CacheEnvironment.skewed(
        trace.n, trace.m, CostParams(), price_sigma=0.8, seed=1),
        cost_model="heterogeneous", **kw)


@pytest.mark.parametrize("starts", STARTS)
@pytest.mark.parametrize("L", LENGTHS)
def test_seg_scans_equal_pallas_and_oracle(L, starts):
    v, s = _inputs(L, starts, L)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    got_max = seg_running_max(tv, ts)
    got_v, got_i = seg_running_argmax(tv, ts)
    assert got_i.dtype == torch.int32
    with jax.enable_x64(True):
        pv = np.asarray(pallas_max(jnp.asarray(v), jnp.asarray(s),
                                   interpret=True))
        av, ai = pallas_argmax(jnp.asarray(v), jnp.asarray(s), interpret=True)
    ov = seg_running_max_ref(v, s)
    rv, ri = seg_running_argmax_ref(v, s)
    assert np.array_equal(got_max.numpy(), pv)
    assert np.array_equal(got_max.numpy(), ov)
    assert np.array_equal(got_v.numpy(), np.asarray(av))
    assert np.array_equal(got_i.numpy(), np.asarray(ai))
    assert np.array_equal(got_v.numpy(), rv)
    assert np.array_equal(got_i.numpy().astype(np.int64), ri)


@pytest.mark.parametrize("starts", ["first", "p0.01"])
def test_seg_scans_long_stream_equal_oracle(starts):
    """L = 100,000: longer than one block's 1024 threads x 64 positions."""
    v, s = _inputs(100_000, starts, 3)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    assert np.array_equal(seg_running_max(tv, ts).numpy(),
                          seg_running_max_ref(v, s))
    got_v, got_i = seg_running_argmax(tv, ts)
    rv, ri = seg_running_argmax_ref(v, s)
    assert np.array_equal(got_v.numpy(), rv)
    assert np.array_equal(got_i.numpy().astype(np.int64), ri)


@pytest.mark.parametrize("starts", ["all", "first", "p0.01", "p0.5"])
@pytest.mark.parametrize("L", [1, 7, 256, 8193])
@pytest.mark.parametrize("S", [1, 3])
def test_scan_step_plain_equals_pallas_and_oracle(S, L, starts):
    """The replay step's two scans (what ``seg_scan_step`` runs on the
    CPU) equal, lane by lane, the Pallas kernels and the numpy oracles on
    the operands ``t + dt[lane, j]`` formed in numpy."""
    args = _step_inputs(S, L, starts, S * L)
    t_a, j_a, s_a, t_m, j_m, s_m, dt = args
    targs = [torch.from_numpy(a) for a in args]
    v, bidx, vmax = seg_scan_step(*targs)
    want = seg_scan_step_plain(*targs)
    assert all(torch.equal(a, b) for a, b in zip((v, bidx, vmax), want))
    assert v.shape == bidx.shape == vmax.shape == (S, L)
    assert bidx.dtype == torch.int64
    for lane in range(S):
        va, vm = t_a + dt[lane, j_a], t_m + dt[lane, j_m]
        with jax.enable_x64(True):
            pv, pi = pallas_argmax(jnp.asarray(va), jnp.asarray(s_a),
                                   interpret=True)
            pm = pallas_max(jnp.asarray(vm), jnp.asarray(s_m),
                            interpret=True)
        rv, ri = seg_running_argmax_ref(va, s_a)
        assert np.array_equal(v[lane].numpy(), np.asarray(pv))
        assert np.array_equal(bidx[lane].numpy(), np.asarray(pi))
        assert np.array_equal(v[lane].numpy(), rv)
        assert np.array_equal(bidx[lane].numpy(), ri)
        assert np.array_equal(vmax[lane].numpy(), np.asarray(pm))
        assert np.array_equal(vmax[lane].numpy(),
                              seg_running_max_ref(vm, s_m))


@pytest.mark.parametrize("name", ["akpc", "no_packing"])
def test_hetero_replay_runs_one_scan_step_a_step(monkeypatch, name):
    """A host-schedule replay under heterogeneous prices (per-server dt) on
    the CPU calls ``seg_scan_step`` once a step and leaves the numpy
    engine's state float for float and its costs."""
    ref, trace = _hetero_trace()
    kw = dict(t_cg=0.61, top_frac=0.5) if name == "akpc" else {}
    calls = []

    def counted(*a):
        calls.append(a[0].shape[0])
        return seg_scan_step(*a)

    monkeypatch.setattr(segment_reduce, "seg_scan_step", counted)
    res = run_policy(_hetero_policy(name, trace, **kw), trace, device="cpu")
    pol = ref_get_policy(name, params=RefParams(), env=RefEnv.skewed(
        ref.n, ref.m, RefParams(), price_sigma=0.8, seed=1),
        cost_model="heterogeneous", **kw)
    pol.bind(ref.n, ref.m)
    eng = RefReplayEngine(ref.n, ref.m, pol.params,
                          env=RefEnv.resolve(pol.env, ref, pol.params),
                          cost_model="heterogeneous",
                          caching_charge=pol.caching_charge,
                          seed_new_cliques=pol.seed_new_cliques)
    eng.replay(ref, clique_generator=pol.on_window if pol.t_cg else None,
               t_cg=pol.t_cg)
    assert res.loop_stats["path"] == "host_schedule"
    assert len(calls) == res.loop_stats["steps"] > 0
    assert np.array_equal(res.state.partition.clique_of,
                          eng.state.partition.clique_of)
    assert np.array_equal(res.state.E, eng.state.E)
    assert np.array_equal(res.state.anchor, eng.state.anchor)
    assert res.costs.n_misses == eng.costs.n_misses
    assert res.costs.n_hits == eng.costs.n_hits
    assert np.isclose(res.total, eng.costs.total, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("bad", ["negative", "m"])
@pytest.mark.parametrize("key", ["j_s", "cj_j_s"])
def test_replay_refuses_server_ids_out_of_range(monkeypatch, key, bad):
    """The replay checks the scans' server ids against m on the host before
    its loop, so neither the kernel (which would price the id as NaN) nor
    the plain chain (which would raise or wrap) sees one outside [0, m)."""
    _, trace = _hetero_trace()
    real = schedule_mod.build_schedule

    def corrupted(*a, **kw):
        sch = real(*a, **kw)
        sch.xs[key][0, 0] = -1 if bad == "negative" else trace.m
        return sch

    monkeypatch.setattr(schedule_mod, "build_schedule", corrupted)
    with pytest.raises(ValueError, match=f"{key} holds server ids outside"):
        run_policy(_hetero_policy("no_packing", trace), trace, device="cpu")


def test_seg_scans_plain_is_what_cpu_wrapper_runs():
    v, s = _inputs(513, "p0.5", 9)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    assert torch.equal(seg_running_max(tv, ts), seg_running_max_plain(tv, ts))
    a, b = seg_running_argmax(tv, ts), seg_running_argmax_plain(tv, ts)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    e = torch.zeros(0, dtype=torch.float64)
    assert seg_running_max(e, torch.zeros(0, dtype=torch.bool)).shape == (0,)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("C,omega,d,R", [(4096, 5, 128, 300), (60, 1, 1, 777),
                                         (33, 3, 7, 64), (5, 2, 3, 1)])
def test_packed_lookup_equals_pallas(C, omega, d, R, dtype):
    rng = np.random.default_rng(C + R)
    table = (rng.standard_normal((C, omega, d)) * 100).astype(dtype)
    ids = rng.integers(0, C, size=R).astype(np.int32)
    got = packed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    assert torch.equal(got, packed_lookup_plain(torch.from_numpy(table),
                                                torch.from_numpy(ids)))
    with jax.enable_x64(True):
        want = np.asarray(pallas_packed_lookup(
            jnp.asarray(table), jnp.asarray(ids), interpret=True))
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


def test_packed_lookup_plain_refuses_out_of_range_ids():
    table = torch.zeros((4, 1, 1), dtype=torch.int32)
    with pytest.raises(IndexError):
        packed_lookup(table, torch.tensor([0, 4], dtype=torch.int32))


@pytest.mark.parametrize("n,shape", [(60, (500, 5)), (10_000, (4096,)),
                                     (1, (3, 2))])
def test_clique_lookup_equals_reference(n, shape):
    rng = np.random.default_rng(n)
    clique_of = rng.permutation(n).astype(np.int32)
    items = rng.integers(-1, n, size=shape)
    got = clique_lookup(clique_of, items, device="cpu")
    want = ref_clique_lookup(clique_of, items)
    assert np.array_equal(got, want)
    with jax.enable_x64(True):
        via_pallas = ref_clique_lookup(clique_of, items, use_pallas=True,
                                       interpret=True)
    assert np.array_equal(got, via_pallas)
    look = CliqueLookup("cpu")
    assert np.array_equal(look(clique_of, items), want)
    assert look.calls == 1 and look.bytes_down == 4 * items.size


def test_clique_lookup_refuses_ids_outside_catalog():
    with pytest.raises(IndexError):
        clique_lookup(np.arange(5, dtype=np.int32), np.array([0, 5]),
                      device="cpu")
