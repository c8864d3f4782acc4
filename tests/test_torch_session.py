"""The port's streaming CacheSession on the CPU against the reference's.

``repro_torch.core.CacheSession(..., device="cpu")`` fed a trace in
chunks must, after every chunk, hold the same partition and the same
``E`` / anchors float for float as ``repro``'s numpy ``CacheSession`` fed
the same chunks, with costs equal at 1e-9 relative and integer counters
exact; and after the last chunk equal ``repro``'s offline
``run_policy(backend="numpy")``.  For ``akpc``, ``ttl``, ``no_packing``,
``packcache`` and ``dp_greedy`` under table1 and heterogeneous pricing
(per-server dt), at chunkings 1, 64, 333, 4096 and the whole trace.
Also: time travel refused, single-request rows, a mid-window snapshot
that resumes bit for bit, snapshots crossing between the packages in both
directions, the ``save`` / ``load_snapshot`` round trip and the refusals
of a snapshot priced under another scenario.
"""
import numpy as np
import pytest

from repro.core import CacheEnvironment as RefEnv
from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core import run_policy as ref_run_policy
from repro.core.session import CacheSession as RefSession
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.checkpoint import latest_step
from repro_torch.convert import trace_from_arrays
from repro_torch.core import (
    CacheEnvironment,
    CacheSession,
    CostParams,
    get_policy,
    load_snapshot,
)

PARAMS = dict(theta=0.2, gamma=0.85, omega=4)
T_CG = 0.61
COUNTERS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
            "items_transferred")
FLOATS = ("transfer", "caching", "keepalive_rent", "total")
POLICIES = ["akpc", "ttl", "no_packing", "packcache", "dp_greedy"]
COST_MODELS = ["table1", "heterogeneous"]
#: requests a chunk (None: the whole trace as one chunk); chunks of 1
#: run over the trace's head only
CHUNKINGS = [1, 64, 333, 4096, None]
N_REQUESTS = 1200
HEAD_OF_ONES = 300


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
        kind="netflix", n_items=40, n_servers=8, n_requests=N_REQUESTS,
        t_max=6.0, bundle_cover=1.0, bundle_zipf=0.7, seed=11,
        size_dist="lognormal"))
    port = trace_from_arrays(ref.items, ref.servers, ref.times, ref.n, ref.m,
                             sizes=ref.sizes)
    return ref, port


def _sessions(name, cost_model, ref, port, *, port_only=False):
    """(reference numpy session, port CPU session) of one scenario."""
    penv = None
    if cost_model == "heterogeneous":
        penv = CacheEnvironment.skewed(port.n, port.m, CostParams(**PARAMS),
                                       price_sigma=0.8, seed=1)
    ps = CacheSession(
        get_policy(name, params=CostParams(**PARAMS), env=penv,
                   cost_model=cost_model, **_policy_kw(name)),
        port.n, port.m, trace=port, device="cpu")
    if port_only:
        return ps
    renv = None
    if cost_model == "heterogeneous":
        renv = RefEnv.skewed(ref.n, ref.m, RefParams(**PARAMS),
                             price_sigma=0.8, seed=1)
    rs = RefSession(
        ref_get_policy(name, params=RefParams(**PARAMS), env=renv,
                       cost_model=cost_model, **_policy_kw(name)),
        ref.n, ref.m, trace=ref)
    return rs, ps


def _same_costs(a, b, exact=False):
    da = a if isinstance(a, dict) else a.as_dict()
    db = b if isinstance(b, dict) else b.as_dict()
    for f in COUNTERS:
        assert da[f] == db[f], f"{f}: {da[f]} != {db[f]}"
    for f in FLOATS:
        if exact:
            assert da[f] == db[f], f"{f}: {da[f]!r} != {db[f]!r}"
        else:
            assert np.isclose(da[f], db[f], rtol=1e-9, atol=1e-9), \
                f"{f}: {da[f]!r} != {db[f]!r}"


def _same_state(a, b):
    """Two sessions (of either package): partition, E, anchor equal."""
    assert np.array_equal(a.partition.clique_of, b.partition.clique_of)
    assert np.array_equal(a.engine.state.E, b.engine.state.E)
    assert np.array_equal(a.engine.state.anchor, b.engine.state.anchor)


def _feed(sess, tr, lo, hi):
    sess.feed(tr.items[lo:hi], tr.servers[lo:hi], tr.times[lo:hi])


@pytest.mark.parametrize("chunk", CHUNKINGS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("cost_model", COST_MODELS)
@pytest.mark.parametrize("name", POLICIES)
def test_session_matches_reference_at_every_chunk(traces, name, cost_model,
                                                  chunk):
    ref, port = traces
    rs, ps = _sessions(name, cost_model, ref, port)
    total = HEAD_OF_ONES if chunk == 1 else ref.n_requests
    step = chunk or total
    for lo in range(0, total, step):
        hi = min(lo + step, total)
        _feed(rs, ref, lo, hi)
        _feed(ps, port, lo, hi)
        _same_state(rs, ps)
        _same_costs(rs.costs, ps.costs)
    assert ps.now == rs.now
    res = ps.result()
    assert res.n_windows == rs.result().n_windows
    if total == ref.n_requests:
        off = ref_run_policy(
            ref_get_policy(name, params=RefParams(**PARAMS), env=rs.env,
                           cost_model=cost_model, **_policy_kw(name)),
            ref, backend="numpy")
        _same_costs(off.costs, ps.costs)
        assert np.array_equal(off.clique_sizes, res.clique_sizes)


def test_feed_refuses_time_travel_and_bad_shapes(traces):
    _, port = traces
    sess = _sessions("no_packing", "table1", None, port, port_only=True)
    _feed(sess, port, 50, 100)
    with pytest.raises(ValueError):
        _feed(sess, port, 0, 50)
    with pytest.raises(ValueError):
        sess.feed(port.items[100:110], port.servers[100:109],
                  port.times[100:110])
    # refused chunks leave the session where it was
    assert sess.costs.n_requests == 50 and sess.now == port.times[99]


@pytest.mark.parametrize("name", ["akpc", "ttl"])
def test_single_request_rows(traces, name):
    """1-D item rows, one request a feed, through windows."""
    ref, port = traces
    rs, ps = _sessions(name, "table1", ref, port)
    for i in range(HEAD_OF_ONES):
        rs.feed(ref.items[i], [ref.servers[i]], [ref.times[i]])
        ps.feed(port.items[i], [port.servers[i]], [port.times[i]])
    _same_state(rs, ps)
    _same_costs(rs.costs, ps.costs)
    assert ps.result().n_windows >= 2


def _chunks(total, cs):
    return [(s, min(s + cs, total)) for s in range(0, total, cs)]


@pytest.mark.parametrize("cost_model", COST_MODELS)
@pytest.mark.parametrize("name", ["akpc", "ttl", "packcache"])
def test_mid_window_snapshot_resumes_bitwise(traces, name, cost_model):
    _, port = traces
    chunks = _chunks(port.n_requests, 97)
    cut = len(chunks) // 2
    full = _sessions(name, cost_model, None, port, port_only=True)
    for lo, hi in chunks:
        _feed(full, port, lo, hi)
    half = _sessions(name, cost_model, None, port, port_only=True)
    for lo, hi in chunks[:cut]:
        _feed(half, port, lo, hi)
    snap = half.snapshot()
    assert snap["session"]["win_items"].shape[0] > 0       # window open
    resumed = _sessions(name, cost_model, None, port,
                        port_only=True).restore(snap)
    for lo, hi in chunks[cut:]:
        _feed(resumed, port, lo, hi)
    _same_state(full, resumed)
    _same_costs(full.costs, resumed.costs, exact=True)
    a, b = full.result(), resumed.result()
    assert a.n_windows == b.n_windows
    assert all(np.array_equal(x, y)
               for x, y in zip(a.size_history, b.size_history))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("cost_model", COST_MODELS)
@pytest.mark.parametrize("name", ["akpc", "ttl", "no_packing"])
def test_snapshot_crosses_packages(traces, name, cost_model, direction):
    """A mid-window snapshot of one package's session restores into the
    other's, which then finishes the trace like an uninterrupted session
    of the first package: state equal float for float, costs at 1e-9."""
    ref, port = traces
    cut = 701
    rs, ps = _sessions(name, cost_model, ref, port)
    src, dst = (rs, ps) if direction == "reference_to_port" else (ps, rs)
    tr_src, tr_dst = ((ref, port) if direction == "reference_to_port"
                      else (port, ref))
    _feed(src, tr_src, 0, cut)
    snap = src.snapshot()
    assert snap["session"]["win_items"].shape[0] > 0 or name == "no_packing"
    dst.restore(snap)
    _same_state(src, dst)
    _same_costs(src.costs, dst.costs, exact=True)
    _feed(src, tr_src, cut, ref.n_requests)
    _feed(dst, tr_dst, cut, ref.n_requests)
    _same_state(src, dst)
    _same_costs(src.costs, dst.costs)
    assert src.result().n_windows == dst.result().n_windows


def test_save_load_snapshot_roundtrip(traces, tmp_path):
    _, port = traces
    half = port.n_requests // 2
    a = _sessions("akpc", "heterogeneous", None, port, port_only=True)
    _feed(a, port, 0, half)
    a.save(str(tmp_path), step=3)
    # an uncommitted later step is not a snapshot
    (tmp_path / "step_00000009").mkdir()
    assert latest_step(str(tmp_path)) == 3
    with pytest.raises(FileExistsError):
        a.save(str(tmp_path), step=3)
    b = _sessions("akpc", "heterogeneous", None, port,
                  port_only=True).restore(load_snapshot(str(tmp_path)))
    _same_state(a, b)
    _same_costs(a.costs, b.costs, exact=True)
    for s in (a, b):
        _feed(s, port, half, port.n_requests)
    _same_state(a, b)
    _same_costs(a.costs, b.costs, exact=True)
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path / "nothing"))


def test_restore_refuses_another_scenario(traces):
    _, port = traces
    src = _sessions("akpc", "heterogeneous", None, port, port_only=True)
    _feed(src, port, 0, 300)
    snap = src.snapshot()
    table1 = _sessions("akpc", "table1", None, port, port_only=True)
    with pytest.raises(ValueError, match="cost model"):
        table1.restore(snap)
    other = CacheSession(
        get_policy("akpc", params=CostParams(**PARAMS), cost_model=
                   "heterogeneous", env=CacheEnvironment.skewed(
                       port.n, port.m, CostParams(**PARAMS), price_sigma=0.8,
                       seed=2), **_policy_kw("akpc")),
        port.n, port.m, trace=port, device="cpu")
    with pytest.raises(ValueError, match="environment mismatch"):
        other.restore(snap)
    tiered = CacheSession(
        get_policy("akpc", params=CostParams(**PARAMS), cost_model="tiered",
                   **_policy_kw("akpc")),
        port.n, port.m, trace=port, device="cpu")
    snap_t = tiered.snapshot()
    assert np.array_equal(snap_t["engine"]["model_config"],
                          [1.0, 1.0, CostParams().alpha])
    snap_t["engine"]["model_config"] = np.array([2.0, 1.0, 0.5])
    with pytest.raises(ValueError, match="differently-configured"):
        CacheSession(
            get_policy("akpc", params=CostParams(**PARAMS),
                       cost_model="tiered", **_policy_kw("akpc")),
            port.n, port.m, trace=port, device="cpu").restore(snap_t)
