"""The port's ``row_sharded`` state layout and sweep mesh on the CPU.

Mirrors ``tests/test_state_layout.py``'s row-sharded contract with the
reference as oracle: the geometry (rows padded to a shard multiple, the
dump row last) and its errors equal ``repro``'s; ``make_sweep_mesh``
follows the reference's rules on a mesh of logical CPU shards
(``devices=["cpu"] * 4``, the counterpart of the reference's
``--xla_force_host_platform_device_count=4``); a replay under
``row_sharded`` (3 shards without a mesh: the geometry alone; 4 row blocks
on a logical mesh: the state split, every row access routed) costs what
the reference's numpy ``run_policy`` does at 1e-9 (integers exact) and
leaves the port's dense run's state float for float and its costs bit for
bit, for ``akpc``, ``no_packing`` and ``ttl`` under table1 and
heterogeneous pricing, at n = 10^4 and at n = 1; a 2 x 2 mesh sweep
equals the serial backend and the reference; snapshots keep the
reference's shard rule, including a reference-made row-sharded snapshot,
and restore from row-sharded into dense mid-stream; the live engine's
device clique generation is off under sharded rows.
"""
import numpy as np
import pytest
import torch

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core import run_policy as ref_run_policy
from repro.core.session import CacheSession as RefSession
from repro.core.state_layout import StateLayout as RefLayout
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace
from repro.traces.loader import Trace as RefTrace

from repro_torch.bench import sweep_bench
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
from repro_torch.core.replay import run_policy_torch, state_to_device
from repro_torch.core.schedule import build_schedule, pad_schedule, schedule_dims
from repro_torch.core.sharded_state import (
    RowShardedState,
    ShardedRows,
    put_rows,
    take_rows,
)
from repro_torch.core.state_layout import StateLayout
from repro_torch.kernels.autowire import cgm_hooks
from repro_torch.launch import (
    dp_axes,
    dp_size,
    make_sweep_mesh,
    make_test_mesh,
)
from repro_torch.serving import LiveServingEngine
from repro_torch.traces.loader import Trace

INT_FIELDS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred")
FLOAT_FIELDS = ("transfer", "caching", "keepalive_rent", "total")
T_CG = 0.9
CPU4 = ["cpu"] * 4
SHARDED3 = StateLayout(kind="row_sharded", shards=3)


def _mesh4():
    return make_sweep_mesh(4, state_rows=4, devices=CPU4)


LAYOUTS = {"shards3": lambda: SHARDED3,
           "mesh4": lambda: StateLayout(kind="row_sharded", mesh=_mesh4())}


def _traces(n_items=40, n_servers=10, n_requests=2500, seed=5, **kw):
    """The reference test's ``_trace()`` in both packages."""
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


def _envs(ref_trace, port, cost_model):
    if cost_model == "table1":
        return None, None
    renv = RefEnv.skewed(ref_trace.n, ref_trace.m, RefParams(),
                         price_sigma=1.0, seed=1)
    return renv, env_from_arrays(port.n, port.m, CostParams(), renv.lam_j,
                                 renv.mu_j)


def _ref_policy(name, renv=None, cost_model="table1"):
    return ref_get_policy(name, params=RefParams(), env=renv,
                          cost_model=cost_model, **_kw(name))


def _port_policy(name, penv=None, cost_model="table1", hooks=False):
    """The port's policy; ``hooks=True`` gives AKPC explicit host CRM hooks
    (the plain versions on the CPU), so a dense run takes the host
    schedule as a row-sharded one does."""
    kw = {}
    if hooks and name == "akpc":
        mm, pe = cgm_hooks("cpu")
        kw = dict(crm_matmul=mm, pair_edges=pe)
    return get_policy(name, params=CostParams(), env=penv,
                      cost_model=cost_model, **_kw(name, **kw))


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
# geometry and the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_geometry_equals_reference(shards):
    lay = StateLayout(kind="row_sharded", shards=shards)
    ref = RefLayout(kind="row_sharded", shards=shards)
    assert lay.row_shards == ref.row_shards == shards
    for n in (1, 59, 60, 63, 9_999, 10_000):
        for m in (1, 10, 600):
            assert lay.state_dims(n, m) == ref.state_dims(n, m)
            assert lay.dump_row(n) == ref.dump_row(n)
            assert lay.is_dense_for(n, m) == ref.is_dense_for(n, m)
            assert lay.supports_device_cgm(n, m) == \
                ref.supports_device_cgm(n, m)
            assert lay.state_bytes(n, m) == ref.state_bytes(n, m)
            assert lay.state_bytes_per_device(n, m) == \
                ref.state_bytes_per_device(n, m)
        assert lay.state_rows(n) % shards == 0
    assert lay.tag == ref.tag == "row_sharded"
    for resolve in (StateLayout.resolve, RefLayout.resolve):
        with pytest.raises(ValueError, match="needs a mesh"):
            resolve("row_sharded")
    with pytest.raises(ValueError, match="shards >= 1"):
        StateLayout(kind="row_sharded", shards=0)


def test_make_sweep_mesh_rules():
    mesh1 = make_sweep_mesh(devices=CPU4)
    assert mesh1.axis_names == ("scenario",) and mesh1.shape == {
        "scenario": 4}
    mesh = make_sweep_mesh(4, state_rows=2, devices=CPU4)
    assert mesh.axis_names == ("scenario", "state_row")
    assert mesh.shape == {"scenario": 2, "state_row": 2}
    assert mesh.devices.shape == (2, 2) and mesh.size == 4
    assert mesh.physical_devices == 1 and mesh.home == torch.device("cpu")
    assert mesh.row_devices(1) == [torch.device("cpu")] * 2
    assert make_sweep_mesh(state_rows=4, devices=CPU4).shape == {
        "scenario": 1, "state_row": 4}
    with pytest.raises(ValueError, match="must divide"):
        make_sweep_mesh(4, state_rows=3, devices=CPU4)
    with pytest.raises(ValueError, match="devices given"):
        make_sweep_mesh(2, devices=CPU4)
    if not torch.cuda.is_available():
        for make in (make_sweep_mesh,
                     lambda: make_sweep_mesh(devices=["cuda:0"] * 2)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    test = make_test_mesh(devices=CPU4)
    assert test.shape == {"data": 2, "model": 2}
    assert dp_axes(test) == ("data",) and dp_size(test) == 2
    assert make_test_mesh(devices=["cpu"]).shape == {"data": 1, "model": 1}
    # the layout reads its shard count from the mesh, and a bare
    # row_sharded layout adopts the sweep's mesh
    assert StateLayout(kind="row_sharded", mesh=mesh).row_shards == 2
    assert not StateLayout(kind="row_sharded", mesh=mesh1).places_rows
    with pytest.raises(ValueError, match="one block a device"):
        StateLayout(kind="row_sharded", mesh=mesh, shards=3)
    eng = SweepEngine(mesh=mesh, layout=StateLayout(kind="row_sharded"))
    assert eng.layout.mesh is mesh and eng.layout.places_rows


def test_place_state_spans_blocks():
    """The reference's placement test: a row-sharded layout on a 4-shard
    mesh spreads the rows over the ``state_row`` devices, the dump row in
    the last block; reading back drops nothing but scratch rows."""
    lay = StateLayout(kind="row_sharded", mesh=_mesh4())
    rows, cols = lay.state_dims(63, 10)
    rng = np.random.default_rng(0)
    E0 = rng.random((rows, cols))
    a0 = rng.integers(-1, cols, rows)
    E, a = lay.place_state(E0, a0)
    assert isinstance(E, ShardedRows) and len(E.blocks) == 4
    assert len(a.blocks) == 4 and tuple(E.shape) == (rows, cols)
    assert all(tuple(b.shape) == (rows // 4 + 1, cols) for b in E.blocks)
    assert np.array_equal(E.to_dense().numpy(), E0)
    assert np.array_equal(a.head(rows), a0)
    assert np.array_equal(E.head(17), E0[:17])
    last = E.blocks[-1]
    assert np.array_equal(last[rows // 4 - 1].numpy(), E0[lay.dump_row(63)])
    # dense and geometry-only layouts leave the state as it is
    for other in (StateLayout(), SHARDED3):
        E, a = other.place_state(E0, a0)
        assert E is E0 and a is a0


@pytest.mark.parametrize("width", [0, 5], ids=["anchor", "E"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "lanes"])
def test_sharded_take_put_equal_dense(width, shared):
    """Routed takes and puts, by row and by flat ``row * m + col`` index,
    equal the dense ones bit for bit in input order; indices repeat only
    at the dump row (the last row), which gets one value."""
    rng = np.random.default_rng(7)
    S, rows, n = 3, 24, 20
    E = torch.as_tensor(rng.random((S, rows, max(width, 1))))
    A = torch.as_tensor(rng.integers(-1, 9, (S, rows)))
    st = RowShardedState.from_dense(E, A, CPU4)
    sh, dense = (st.E, E.clone()) if width else (st.anchor, A.clone())
    idx = torch.as_tensor(np.concatenate([
        rng.permutation(rows - 1)[: n - 4], [rows - 1] * 4]))
    if not shared:
        idx = torch.stack([idx[torch.as_tensor(rng.permutation(n))]
                           for _ in range(S)])
    assert torch.equal(take_rows(sh, idx), take_rows(dense, idx))
    src = take_rows(dense, idx) + 1
    dump = idx == rows - 1
    src[(slice(None), dump) if shared else dump] = 7
    put_rows(sh, idx, src)
    put_rows(dense, idx, src)
    assert torch.equal(sh.to_dense(), dense)
    if width:
        flat, flat_d = sh.view(S, rows * width), dense.view(S, rows * width)
        fidx = idx * width + torch.as_tensor(
            rng.integers(0, width, tuple(idx.shape)))
        assert torch.equal(take_rows(flat, fidx), take_rows(flat_d, fidx))
        fsrc = torch.where(fidx // width == rows - 1, 0.25,
                           take_rows(flat_d, fidx) * 2)
        put_rows(flat, fidx, fsrc)
        put_rows(flat_d, fidx, fsrc)
        assert torch.equal(sh.to_dense(), dense)
    assert st.stats["block_ops"] > 0 and st.stats["device_copies"] == 0
    with pytest.raises(RuntimeError, match="moves no block"):
        sh.take(idx.to("meta"))


# ---------------------------------------------------------------------------
# replay parity: the reference at 1e-9, the dense run bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["shards3", "mesh4"])
@pytest.mark.parametrize("cost_model", ["table1", "heterogeneous"])
@pytest.mark.parametrize("policy", ["akpc", "no_packing", "ttl"])
def test_replay_parity_row_sharded(layout, cost_model, policy):
    ref_trace, port = _traces()
    renv, penv = _envs(ref_trace, port, cost_model)
    lay = LAYOUTS[layout]()
    want = ref_run_policy(_ref_policy(policy, renv, cost_model), ref_trace)
    got = run_policy_torch(_port_policy(policy, penv, cost_model), port,
                           device="cpu", layout=lay)
    assert got.loop_stats["path"] == "host_schedule"   # never device CGM
    assert_same_costs(want.costs, got.costs)
    if layout == "mesh4":
        assert got.loop_stats["shards"] == 4
        assert got.loop_stats["block_ops"] > 0
    # the dense run of the same lanes (AKPC with host hooks in both, so
    # both take the host schedule): state float for float, costs bitwise
    sharded = run_policy_torch(_port_policy(policy, penv, cost_model, True),
                               port, device="cpu", layout=lay)
    dense = run_policy_torch(_port_policy(policy, penv, cost_model, True),
                             port, device="cpu")
    assert_same_state(dense.state, sharded.state)
    assert dense.costs.as_dict() == sharded.costs.as_dict()
    assert_same_state(got.state, sharded.state)


@pytest.mark.parametrize("layout", ["shards4", "mesh4"])
def test_replay_parity_large_catalog(layout):
    """The reference's catalog-scale gate: n = 10^4 items x 24 servers,
    4,000 requests, 4 row shards."""
    ref_trace, port = _traces(n_items=10_000, n_servers=24,
                              n_requests=4000, seed=1, server_affinity=2)
    lay = (StateLayout(kind="row_sharded", shards=4) if layout == "shards4"
           else LAYOUTS["mesh4"]())
    want = ref_run_policy(_ref_policy("no_packing"), ref_trace)
    got = run_policy_torch(_port_policy("no_packing"), port, device="cpu",
                           layout=lay)
    assert_same_costs(want.costs, got.costs)
    dense = run_policy_torch(_port_policy("no_packing"), port, device="cpu")
    assert_same_state(dense.state, got.state)
    assert dense.costs.as_dict() == got.costs.as_dict()


def test_replay_parity_n_equals_1():
    """One item: 4 state rows (the padded row, the dump row) over 4 blocks
    of one row each, the dump row alone in the last block."""
    rng = np.random.default_rng(0)
    R = 400
    arrays = dict(times=np.sort(rng.uniform(0.0, 20.0, R)),
                  servers=rng.integers(0, 3, R).astype(np.int32),
                  items=np.zeros((R, 1), np.int32), n=1, m=3)
    lay = LAYOUTS["mesh4"]()
    assert lay.state_dims(1, 3) == (4, 3)
    want = ref_run_policy(ref_get_policy("no_packing", params=RefParams()),
                          RefTrace(name="one-item", **arrays))
    got = run_policy_torch(get_policy("no_packing", params=CostParams()),
                           Trace(name="one-item", **arrays), device="cpu",
                           layout=lay)
    assert_same_costs(want.costs, got.costs)


def test_pad_schedule_keeps_row_sharded_geometry():
    _, port = _traces()
    pol = get_policy("akpc", params=CostParams(), **_kw("akpc"))
    pol.bind(port.n, port.m)
    env = CacheEnvironment.resolve(None, port, CostParams())
    s = build_schedule(
        CliquePartition.singletons(port.n), port, pol.on_window, pol.t_cg,
        model=get_cost_model("table1", env), env=env, layout=SHARDED3)
    assert (s.state_rows, s.state_cols) == SHARDED3.state_dims(port.n,
                                                               port.m)
    dims = {k: v + 7 for k, v in schedule_dims(s).items()}
    padded = pad_schedule(s, dims)
    assert (padded.state_rows, padded.state_cols) == (s.state_rows,
                                                      s.state_cols)
    K = s.state_rows - 1
    assert int(padded.xs["ev_c"].max()) <= K
    assert int(padded.xs["ev_c"][-1, -1]) == K


# ---------------------------------------------------------------------------
# the sweep mesh
# ---------------------------------------------------------------------------
def test_sweep_mesh_row_sharded_against_serial():
    """A 2 x 2 mesh sweep under a bare row_sharded layout (it adopts the
    mesh): lanes split over the scenario axis when it divides them, rows
    over ``state_row``; every point equals the serial backend and the
    reference at 1e-9 (the lane split changes the shapes the per-lane cost
    sums reduce over, so not bitwise) and the mesh-less sweep's state float
    for float; AKPC takes the host schedule (no device-CGM super-group)."""
    mesh = make_sweep_mesh(4, state_rows=2, devices=CPU4)
    traces = [_traces(seed=s) for s in range(2)]
    renv, penv = _envs(*traces[0], "heterogeneous")
    pts, refs = [], []
    for ref_trace, port in traces:
        for alpha in (0.6, 0.8):
            pts.append(SweepPoint("akpc", port, dict(
                params=CostParams(alpha=alpha), t_cg=T_CG, top_frac=1.0)))
            refs.append((ref_get_policy("akpc", params=RefParams(
                alpha=alpha), t_cg=T_CG, top_frac=1.0), ref_trace))
        for theta in (0.2, 0.3):          # would be a device-CGM group
            pts.append(SweepPoint("akpc", port, dict(
                params=CostParams(theta=theta), t_cg=T_CG, top_frac=1.0)))
            refs.append((ref_get_policy("akpc", params=RefParams(
                theta=theta), t_cg=T_CG, top_frac=1.0), ref_trace))
    ref_trace, port = traces[0]
    for name in ("no_packing", "packcache"):
        for sigma_env in (penv,):
            pts.append(SweepPoint(name, port, dict(
                params=CostParams(), env=sigma_env,
                cost_model="heterogeneous", **_kw(name))))
            refs.append((_ref_policy(name, renv, "heterogeneous"),
                         ref_trace))
    eng = SweepEngine(mesh=mesh, layout=StateLayout(kind="row_sharded"))
    got = eng.run(pts)
    assert eng.last_stats["device_cgm_points"] == 0
    groups = eng.last_stats["groups"]
    assert {g["block"] for g in groups} == {0, 1}
    assert all(g["shards"] == 2 for g in groups)
    serial = SweepEngine(backend="serial", device="cpu").run(pts)
    flat = SweepEngine(device="cpu", layout=StateLayout(
        kind="row_sharded", shards=2)).run(pts)
    for (rp, rt), s, g, f in zip(refs, serial, got, flat):
        assert_same_costs(ref_run_policy(rp, rt).costs, g.costs)
        assert_same_costs(s.costs, g.costs)
        assert_same_costs(f.costs, g.costs)
        assert_same_state(f.state, g.state)


def test_sweep_scenario_mesh_uneven_lanes():
    """A 1-D scenario mesh of 4 logical CPU shards: a group of 4 lanes
    splits into 4 one-lane scans, a group of 3 stays one scan (the
    reference's no-op); the device-CGM path is left as it is."""
    mesh = make_sweep_mesh(devices=CPU4)
    ref_trace, port = _traces()
    pts = [SweepPoint("no_packing", port, dict(params=CostParams(
        alpha=a))) for a in (0.5, 0.6, 0.7, 0.8)]
    pts += [SweepPoint("ttl", port, dict(params=CostParams(alpha=a),
                                         t_cg=T_CG)) for a in (0.5, 0.7, 0.9)]
    eng = SweepEngine(mesh=mesh)
    got = eng.run(pts)
    assert sorted(g["lanes"] for g in eng.last_stats["groups"]) == [
        1, 1, 1, 1, 3]
    for pt, g in zip(pts, got):
        want = ref_run_policy(ref_get_policy(
            pt.policy, params=RefParams(alpha=pt.policy_kwargs[
                "params"].alpha), **_kw(pt.policy)), ref_trace)
        assert_same_costs(want.costs, g.costs)


def test_sweep_bench_mesh_rows(monkeypatch, tmp_path):
    """``sweep_bench --mesh`` at a small size on the CPU: a row a mesh
    shape, each after parity against the mesh-less sweep."""
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    monkeypatch.setattr(sweep_bench, "RESULTS_DIR", str(tmp_path),
                        raising=False)
    rows = sweep_bench.bench_mesh(1500, 4, 2, device="cpu")
    assert [(r["logical_devices"], r["state_rows"]) for r in rows] == list(
        sweep_bench.MESH_SHAPES)
    assert all(r["physical_devices"] == 1 and r["points"] == 8
               and r["warm_seconds"] > 0 for r in rows)


# ---------------------------------------------------------------------------
# snapshots: the shard rule, across packages, row-sharded -> dense
# ---------------------------------------------------------------------------
def _feed(sess, trace, lo, hi):
    sess.feed(trace.items[lo:hi], trace.servers[lo:hi], trace.times[lo:hi])


def _port_session(port, layout=None):
    return CacheSession(get_policy("akpc", params=CostParams(),
                                   **_kw("akpc")),
                        port.n, port.m, layout=layout, device="cpu")


def _ref_session(ref_trace, layout=None):
    return RefSession(_ref_policy("akpc"), ref_trace.n, ref_trace.m,
                      layout=layout)


def test_snapshot_shard_rule():
    """The reference's rule: a row-sharded snapshot restored into a
    row-sharded session must match its shard count; dense and bucketed
    sessions accept it; a reference-made row-sharded snapshot obeys the
    same rule in the port."""
    ref_trace, port = _traces()
    half = port.n_requests // 2
    a = _port_session(port, StateLayout(kind="row_sharded", shards=2))
    _feed(a, port, 0, half)
    snap = a.snapshot()
    assert int(snap["engine"]["layout_shards"]) == 2
    with pytest.raises(ValueError, match="shard"):
        _port_session(port, LAYOUTS["mesh4"]()).restore(snap)
    _port_session(port).restore(snap)
    _port_session(port, StateLayout(kind="bucketed", row_bucket=16,
                                    col_bucket=8)).restore(snap)
    ref = _ref_session(ref_trace, RefLayout(kind="row_sharded", shards=4))
    _feed(ref, ref_trace, 0, half)
    ref_snap = ref.snapshot()
    with pytest.raises(ValueError, match="shard"):
        _port_session(port, SHARDED3).restore(ref_snap)
    b = _port_session(port, LAYOUTS["mesh4"]())
    b.restore(ref_snap)
    _feed(b, port, half, port.n_requests)
    _feed(ref, ref_trace, half, ref_trace.n_requests)
    assert_same_costs(ref.costs, b.costs)
    assert np.array_equal(ref.engine.state.E, b.engine.state.E)


@pytest.mark.parametrize("direction", ["port_to_port", "port_to_reference"])
def test_restore_row_sharded_into_dense_midstream(direction):
    """A session on a 4-shard mesh snapshots half-way; a dense session (the
    port's or the reference's) finishes the trace with the reference's
    costs."""
    ref_trace, port = _traces()
    half = port.n_requests // 2
    whole = _ref_session(ref_trace)
    whole.feed_trace(ref_trace)
    src = _port_session(port, LAYOUTS["mesh4"]())
    _feed(src, port, 0, half)
    if direction == "port_to_port":
        dst = _port_session(port)
        dst.restore(src.snapshot())
        _feed(dst, port, half, port.n_requests)
    else:
        dst = _ref_session(ref_trace)
        dst.restore(src.snapshot())
        _feed(dst, ref_trace, half, ref_trace.n_requests)
    assert_same_costs(whole.costs, dst.costs)
    assert np.array_equal(whole.engine.state.E, dst.engine.state.E)


# ---------------------------------------------------------------------------
# the live engine
# ---------------------------------------------------------------------------
def test_live_engine_row_sharded():
    """Sharded rows turn the live engine's device clique generation off
    (``cgm="force"`` raises); the host-schedule live path keeps its carry
    in row blocks on the mesh and ends where the reference's offline
    replay and a dense live engine do."""
    ref_trace, port = _traces(size_dist="lognormal")
    lay = LAYOUTS["mesh4"]()
    pol = get_policy("akpc", params=CostParams(), **_kw("akpc"))
    assert not LiveServingEngine(pol, port.n, port.m, layout=lay)._cgm
    with pytest.raises(ValueError, match="force"):
        LiveServingEngine(get_policy("akpc", params=CostParams(),
                                     **_kw("akpc")),
                          port.n, port.m, layout=SHARDED3, cgm="force",
                          device="cpu")
    renv, penv = _envs(ref_trace, port, "heterogeneous")
    env = CacheEnvironment.resolve(penv, port, CostParams())
    want = ref_run_policy(_ref_policy("akpc", renv, "heterogeneous"),
                          ref_trace)
    engines = {}
    for key, layout in (("sharded", lay), ("dense", None)):
        eng = LiveServingEngine(
            _port_policy("akpc", penv, "heterogeneous"), port.n, port.m,
            env=env, chunk_size=512, layout=layout,
            device=None if layout is not None else "cpu")
        assert eng.device == torch.device("cpu") and not eng._cgm
        for lo in range(0, port.n_requests, 300):
            hi = min(lo + 300, port.n_requests)
            eng.submit(port.items[lo:hi], port.servers[lo:hi],
                       port.times[lo:hi])
        eng.drain()
        engines[key] = eng
    sh, de = engines["sharded"], engines["dense"]
    assert isinstance(sh._E, ShardedRows) and len(sh._E.blocks) == 4
    assert_same_costs(want.costs, sh.session.costs)
    assert sh.session.costs.as_dict() == de.session.costs.as_dict()
    assert_same_state(de.session.engine.state, sh.session.engine.state)
    # the state read back equals the blocks assembled
    k = sh.partition.k
    E, a = state_to_device(sh.session.engine.state, port.n, "cpu", lay)
    assert np.array_equal(E.head(k), sh._E.head(k))
    assert np.array_equal(a.head(k), sh._anchor.head(k))
