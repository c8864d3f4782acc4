"""The port's ``bucketed`` state layout on the CPU, against the reference.

Mirrors ``tests/test_state_layout.py``: the geometry (rows and columns
round up to buckets, the dump row last) equals the reference's; a replay
under the bucketed layout costs what the reference's numpy engine does at
1e-9 (integers exact) and leaves the state the dense replay leaves, float
for float, for ``akpc`` (the device clique generation and the host one),
``no_packing`` and ``ttl``, under uniform and per-server dt (padded
columns in the scan), and at n = 1; a mixed-(n, m) sweep replays one scan
a bucket cohort, every point equal to the reference; ``pad_schedule``
keeps a schedule's geometry; snapshots cross dense <-> bucketed, within
the port and to and from the reference's sessions; the live engine runs
the bucketed carry.  ``row_sharded`` (ported with the mesh) is held in
``tests/test_torch_mesh.py``.
"""
import numpy as np
import pytest

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core import run_policy as ref_run_policy
from repro.core.session import CacheSession as RefSession
from repro.core.state_layout import StateLayout as RefLayout
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.convert import env_from_arrays, trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CacheSession,
    CliquePartition,
    CostParams,
    SweepEngine,
    SweepPoint,
    get_cost_model,
    get_policy,
)
from repro_torch.core import cliques as port_cliques
from repro_torch.core.replay import run_policy_torch, state_to_device
from repro_torch.core.schedule import build_schedule, pad_schedule, schedule_dims
from repro_torch.core.state_layout import DENSE, StateLayout
from repro_torch.kernels.autowire import cgm_hooks
from repro_torch.serving import LiveServingEngine
from repro_torch.traces.loader import Trace

INT_FIELDS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred")
FLOAT_FIELDS = ("transfer", "caching", "keepalive_rent", "total")
BUCKETED = StateLayout(kind="bucketed", row_bucket=16, col_bucket=8)
T_CG = 0.9


def _traces(n_items=40, n_servers=10, n_requests=2500, seed=5, **kw):
    kw.setdefault("bundle_cover", 1.0)
    kw.setdefault("bundle_zipf", 0.7)
    ref = ref_synth_trace(RefSynthConfig(
        kind="netflix", n_items=n_items, n_servers=n_servers,
        n_requests=n_requests, t_max=20.0, seed=seed, **kw))
    port = trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)
    return ref, port


def _kw(name, **kw):
    if name in ("akpc", "ttl", "packcache"):
        kw.setdefault("t_cg", T_CG)
    if name in ("akpc", "packcache"):
        kw.setdefault("top_frac", 1.0)
    return kw


def _pair(name, ref_env=None, port_env=None, cost_model="table1", **kw):
    """(reference policy, port policy) of one scenario."""
    return (ref_get_policy(name, params=RefParams(), env=ref_env,
                           cost_model=cost_model, **_kw(name)),
            get_policy(name, params=CostParams(), env=port_env,
                       cost_model=cost_model, **_kw(name, **kw)))


def assert_same_costs(ref, got):
    a, b = ref.as_dict(), got.as_dict()
    for f in INT_FIELDS:
        assert a[f] == b[f], f"{f}: {a[f]} != {b[f]}"
    for f in FLOAT_FIELDS:
        assert np.isclose(a[f], b[f], rtol=1e-9, atol=1e-9), \
            f"{f}: {a[f]} != {b[f]}"


def assert_same_state(a, b):
    assert np.array_equal(a.partition.clique_of, b.partition.clique_of)
    assert np.array_equal(a.E, b.E) and np.array_equal(a.anchor, b.anchor)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("buckets", [(16, 8), (64, 32), (1024, 256)])
def test_bucketed_geometry_equals_reference(buckets):
    lay = StateLayout(kind="bucketed", row_bucket=buckets[0],
                      col_bucket=buckets[1])
    ref = RefLayout(kind="bucketed", row_bucket=buckets[0],
                    col_bucket=buckets[1])
    for n, m in ((1, 1), (50, 20), (64, 32), (65, 33), (10_000, 600),
                 (3600, 1200)):
        assert lay.state_dims(n, m) == ref.state_dims(n, m)
        assert lay.dump_row(n) == ref.dump_row(n)
        assert lay.is_dense_for(n, m) == ref.is_dense_for(n, m)
        assert lay.state_bytes(n, m) == ref.state_bytes(n, m)
        assert lay.supports_device_cgm(n, m)
    assert lay.tag == ref.tag == "bucketed"


def test_bucketed_geometry_rounds_up():
    lay = StateLayout(kind="bucketed", row_bucket=64, col_bucket=32)
    assert lay.state_dims(50, 20) == (65, 32)
    assert lay.state_dims(64, 32) == (65, 32)
    assert lay.state_dims(65, 33) == (129, 64)
    assert lay.dump_row(50) == 64          # always the LAST row
    assert lay.state_dims(1, 1) == (65, 32)
    assert not lay.is_dense_for(50, 20) and lay.is_dense_for(64, 32)
    assert StateLayout.resolve(None) is DENSE
    assert DENSE.state_dims(60, 600) == (61, 600) and DENSE.is_dense_for(60, 6)
    assert StateLayout.resolve("bucketed").state_dims(60, 600) == (1025, 768)
    bare = StateLayout(kind="row_sharded")     # no mesh, no shard count
    assert bare.row_shards == 1 and bare.is_dense_for(60, 600)
    assert StateLayout(kind="row_sharded", shards=4).state_dims(60, 600) \
        == (64, 600)
    with pytest.raises(ValueError, match="unknown state layout"):
        StateLayout(kind="tiled")


def test_state_to_device_pads_inert():
    """The live (k, m) block goes top-left; padded rows hold anchor -1 and
    zeros, padded columns zeros."""
    _, port = _traces()
    pol = get_policy("akpc", params=CostParams(), **_kw("akpc"))
    res = run_policy_torch(pol, port, device="cpu")
    st = res.state
    E, a = state_to_device(st, port.n, "cpu", BUCKETED)
    rows, cols = BUCKETED.state_dims(port.n, port.m)
    assert tuple(E.shape) == (rows, cols) and tuple(a.shape) == (rows,)
    k = st.partition.k
    assert np.array_equal(E[:k, :port.m].numpy(), st.E)
    assert not E[:, port.m:].any() and not E[k:].any()
    assert (a[k:] == -1).all() and np.array_equal(a[:k].numpy(), st.anchor)


# ---------------------------------------------------------------------------
# replay parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", [None, BUCKETED], ids=["dense", "bucketed"])
@pytest.mark.parametrize("policy", ["akpc", "no_packing", "ttl"])
def test_replay_parity_layouts(layout, policy):
    ref_trace, port = _traces()
    rp, pp = _pair(policy)
    want = ref_run_policy(rp, ref_trace)
    got = run_policy_torch(pp, port, device="cpu", layout=layout)
    assert_same_costs(want.costs, got.costs)
    dense = run_policy_torch(_pair(policy)[1], port, device="cpu")
    assert_same_state(dense.state, got.state)


@pytest.mark.parametrize("policy", ["akpc", "no_packing"])
def test_replay_parity_bucketed_per_server_dt(policy):
    """Heterogeneous prices (per-server dt: the scans run, ``dt`` padded
    to the layout's columns) and lognormal sizes; ``akpc`` with explicit
    host hooks takes the host schedule under the layout."""
    ref_trace, port = _traces(size_dist="lognormal")
    renv = RefEnv.skewed(ref_trace.n, ref_trace.m, RefParams(),
                         price_sigma=1.0, seed=1)
    penv = env_from_arrays(port.n, port.m, CostParams(), renv.lam_j,
                           renv.mu_j)
    mm, pe = cgm_hooks("cpu")
    hooks = dict(crm_matmul=mm, pair_edges=pe) if policy == "akpc" else {}
    rp, pp = _pair(policy, renv, penv, "heterogeneous", **hooks)
    want = ref_run_policy(rp, ref_trace)
    got = run_policy_torch(pp, port, device="cpu", layout=BUCKETED)
    assert got.loop_stats["path"] == "host_schedule"
    assert not got.loop_stats["const_dt"]
    assert_same_costs(want.costs, got.costs)
    dense = run_policy_torch(
        _pair(policy, renv, penv, "heterogeneous", **hooks)[1], port,
        device="cpu")
    assert_same_state(dense.state, got.state)


def test_replay_parity_n_equals_1():
    rng = np.random.default_rng(0)
    R = 400
    arrays = dict(times=np.sort(rng.uniform(0.0, 20.0, R)),
                  servers=rng.integers(0, 3, R).astype(np.int32),
                  items=np.zeros((R, 1), np.int32), n=1, m=3)
    from repro.traces.loader import Trace as RefTrace

    want = ref_run_policy(ref_get_policy("no_packing", params=RefParams()),
                          RefTrace(name="one-item", **arrays))
    got = run_policy_torch(get_policy("no_packing", params=CostParams()),
                           Trace(name="one-item", **arrays), device="cpu",
                           layout=BUCKETED)
    assert_same_costs(want.costs, got.costs)


def test_device_cgm_under_bucketed():
    """The device clique generation keeps its dense-n carry: a bucketed
    AKPC replay takes it (no host clique generation), equal to the dense
    run and to the reference."""
    ref_trace, port = _traces()
    rp, pp = _pair("akpc")
    before = port_cliques.CGM_CALLS
    got = run_policy_torch(pp, port, device="cpu", layout=BUCKETED)
    assert port_cliques.CGM_CALLS == before
    assert got.loop_stats.get("path") != "host_schedule"
    assert_same_costs(ref_run_policy(rp, ref_trace).costs, got.costs)
    assert np.array_equal(
        got.clique_sizes,
        run_policy_torch(_pair("akpc")[1], port, device="cpu").clique_sizes)


# ---------------------------------------------------------------------------
# bucket cohorts: one scan a cohort, not a point
# ---------------------------------------------------------------------------
def test_mixed_shape_sweep_one_scan_a_cohort():
    lay = StateLayout(kind="bucketed", row_bucket=64, col_bucket=16)
    shapes = [(30, 8), (40, 10), (90, 20), (100, 24)]
    traces = [_traces(n_items=n, n_servers=m, seed=s)
              for s, (n, m) in enumerate(shapes)]
    kw = dict(params=CostParams(), t_cg=T_CG, top_frac=1.0)
    pts = [SweepPoint("akpc", port, kw, tag=f"{n}x{m}")
           for (_, port), (n, m) in zip(traces, shapes)]
    cohorts = {lay.state_dims(n, m) for n, m in shapes}
    assert len(cohorts) == 2
    eng = SweepEngine(layout=lay, device="cpu")
    got = eng.run(pts)
    groups = eng.last_stats["groups"]
    assert len(groups) <= len(cohorts) < len(pts)
    assert sorted(g["lanes"] for g in groups) == [2, 2]
    dense = SweepEngine(device="cpu").run(pts)
    for (ref_trace, _), pt, g, d in zip(traces, pts, got, dense):
        want = ref_run_policy(ref_get_policy(
            "akpc", params=RefParams(), t_cg=T_CG, top_frac=1.0), ref_trace)
        assert_same_costs(want.costs, g.costs)
        assert_same_state(d.state, g.state)


def test_pad_schedule_preserves_state_geometry():
    _, port = _traces()
    pol = get_policy("akpc", params=CostParams(), **_kw("akpc"))
    pol.bind(port.n, port.m)
    env = CacheEnvironment.resolve(None, port, CostParams())
    s = build_schedule(
        CliquePartition.singletons(port.n), port, pol.on_window, pol.t_cg,
        model=get_cost_model("table1", env), env=env, layout=BUCKETED)
    assert (s.state_rows, s.state_cols) == BUCKETED.state_dims(port.n, port.m)
    dims = {k: v + 7 for k, v in schedule_dims(s).items()}
    padded = pad_schedule(s, dims)
    assert (padded.state_rows, padded.state_cols) == (s.state_rows,
                                                      s.state_cols)
    K = s.state_rows - 1
    assert int(padded.xs["ev_c"].max()) <= K
    assert int(padded.xs["ev_c"][-1, -1]) == K


# ---------------------------------------------------------------------------
# snapshots: dense <-> bucketed, and across packages
# ---------------------------------------------------------------------------
def _feed(sess, trace, lo, hi):
    sess.feed(trace.items[lo:hi], trace.servers[lo:hi], trace.times[lo:hi])


def _port_session(port, layout=None):
    return CacheSession(get_policy("akpc", params=CostParams(),
                                   **_kw("akpc")),
                        port.n, port.m, layout=layout, device="cpu")


def _ref_session(ref_trace, layout=None):
    return RefSession(ref_get_policy("akpc", params=RefParams(),
                                     **_kw("akpc")),
                      ref_trace.n, ref_trace.m, layout=layout)


@pytest.mark.parametrize("src_layout,dst_layout", [
    (None, BUCKETED), (BUCKETED, None)], ids=["dense_to_bucketed",
                                             "bucketed_to_dense"])
def test_snapshot_round_trip_dense_bucketed(src_layout, dst_layout):
    _, port = _traces()
    half = port.n_requests // 2
    whole = _port_session(port)
    whole.feed_trace(port)
    a = _port_session(port, src_layout)
    _feed(a, port, 0, half)
    snap = a.snapshot()
    assert bytes(snap["engine"]["layout"]).decode() == (
        "bucketed" if src_layout is not None else "dense")
    b = _port_session(port, dst_layout)
    b.restore(snap)
    _feed(b, port, half, port.n_requests)
    assert_same_costs(whole.costs, b.costs)
    assert_same_state(whole.engine.state, b.engine.state)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_snapshot_crosses_packages_bucketed(direction):
    """A bucketed session's snapshot of one package restores into the
    other's dense session (and a dense one into a bucketed), which then
    finishes the trace as an uninterrupted reference session does."""
    ref_trace, port = _traces()
    half = port.n_requests // 2
    whole = _ref_session(ref_trace)
    whole.feed_trace(ref_trace)
    if direction == "reference_to_port":
        src = _ref_session(ref_trace, RefLayout(kind="bucketed",
                                                row_bucket=16, col_bucket=8))
        _feed(src, ref_trace, 0, half)
        dst = _port_session(port)
        dst.restore(src.snapshot())
        _feed(dst, port, half, port.n_requests)
    else:
        src = _port_session(port, BUCKETED)
        _feed(src, port, 0, half)
        dst = _ref_session(ref_trace)
        dst.restore(src.snapshot())
        _feed(dst, ref_trace, half, ref_trace.n_requests)
    assert_same_costs(whole.costs, dst.costs)
    assert np.array_equal(whole.engine.state.E, dst.engine.state.E)


# ---------------------------------------------------------------------------
# the live engine's bucketed carry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["no_packing", "ttl"])
def test_live_engine_bucketed_carry(policy):
    """The host-schedule live path keeps its carry in the bucketed
    geometry (padded columns under per-server dt) and ends where the
    reference's offline replay does."""
    ref_trace, port = _traces(size_dist="lognormal")
    renv = RefEnv.skewed(ref_trace.n, ref_trace.m, RefParams(),
                         price_sigma=1.0, seed=1)
    penv = env_from_arrays(port.n, port.m, CostParams(), renv.lam_j,
                           renv.mu_j)
    rp, pp = _pair(policy, renv, penv, "heterogeneous")
    want = ref_run_policy(rp, ref_trace)
    # the offline replay threads the trace's sizes into a price-only env
    env = CacheEnvironment.resolve(penv, port, CostParams())
    eng = LiveServingEngine(pp, port.n, port.m, env=env, chunk_size=512,
                            layout=BUCKETED, device="cpu")
    assert not eng._cgm
    for lo in range(0, port.n_requests, 300):
        hi = min(lo + 300, port.n_requests)
        eng.submit(port.items[lo:hi], port.servers[lo:hi], port.times[lo:hi])
    eng.drain()
    assert tuple(eng._E.shape) == BUCKETED.state_dims(port.n, port.m)
    assert not eng._E[:, port.m:].any()
    assert_same_costs(want.costs, eng.session.costs)
