"""The port's LiveServingEngine on the CPU: the contracts of the reference's.

The contracts of ``tests/test_serving_live.py``, held against ``repro``'s
numpy oracles (``run_policy(backend="numpy")`` and the numpy
``CacheSession``), never against its device scan:

* parity: ragged submissions streamed through the live engine price like
  the offline replay (1e-9 relative, integer counters exact) with the
  same partition and state, at chunk sizes that pad the tail, cut windows
  mid-chunk and make one padded chunk; the ``ttl`` policy too;
* one shape ratchet (``compiles``, the reference's compile count) for a
  steady stream, and again for a second engine in the same process;
* a chunked ``CacheSession.feed_trace`` equals the offline replay;
* a snapshot taken mid-flight (chunks dispatched, a ragged remainder
  buffered) restores into a fresh engine that finishes bit for bit like
  an uninterrupted one, and snapshots cross between the live engine and
  both packages' sessions in both directions;
* the serving surface: futures settle, mid-stream costs see dispatched
  chunks, out-of-order submissions are refused, and without CUDA the
  default device raises;
* ``cgm="force"`` runs the device clique generation and equals the
  offline replay, with item sizes too; ``cgm="auto"`` takes it for AKPC
  at a uniform dt;
* the serving bench holds each engine to the offline replay before it
  keeps a time.
"""
import numpy as np
import pytest
import torch

from repro.core import CostParams as RefParams
from repro.core import get_policy as ref_get_policy
from repro.core import run_policy as ref_run_policy
from repro.core.session import CacheSession as RefSession
from repro.traces import SynthConfig as RefSynthConfig
from repro.traces import synth_trace as ref_synth_trace

from repro_torch.bench import serve_bench
from repro_torch.convert import trace_from_arrays
from repro_torch.core import CacheSession, CostParams, get_policy
from repro_torch.serving import LiveServingEngine

T_CG = 0.73                  # never divides the grids: windows split chunks
COUNTERS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
            "items_transferred")
FLOATS = ("transfer", "caching", "keepalive_rent", "total")


def _ref_trace(n_requests=4000, seed=3):
    return ref_synth_trace(RefSynthConfig(
        kind="netflix", n_items=60, n_servers=12, n_requests=n_requests,
        t_max=30.0, bundle_cover=1.0, bundle_zipf=0.7, seed=seed))


def _port(tr):
    return trace_from_arrays(tr.items, tr.servers, tr.times, tr.n, tr.m)


def _kw(name, kw):
    if name == "akpc":
        kw.setdefault("t_cg", T_CG)
        kw.setdefault("top_frac", 1.0)
    if name == "ttl":
        kw.setdefault("t_cg", T_CG)
    return kw


def _policy(name="akpc", **kw):
    return get_policy(name, params=CostParams(), **_kw(name, kw))


def _ref_policy(name="akpc", **kw):
    return ref_get_policy(name, params=RefParams(), **_kw(name, kw))


def _live(trace, name="akpc", **kw):
    return LiveServingEngine(_policy(name), trace.n, trace.m, device="cpu",
                             **kw)


def _stream(eng, trace, seed=0, lo=0, hi=None):
    """Submit [lo, hi) as ragged arrival slices."""
    rng = np.random.default_rng(seed)
    hi = trace.n_requests if hi is None else hi
    while lo < hi:
        k = min(int(rng.integers(1, 300)), hi - lo)
        eng.submit(trace.items[lo:lo + k], trace.servers[lo:lo + k],
                   trace.times[lo:lo + k])
        lo += k


def _same_costs(ref, got, exact=False):
    a = ref if isinstance(ref, dict) else ref.as_dict()
    b = got if isinstance(got, dict) else got.as_dict()
    for f in COUNTERS:
        assert a[f] == b[f], f"{f}: {a[f]} != {b[f]}"
    for f in FLOATS:
        if exact:
            assert a[f] == b[f], f"{f}: {a[f]!r} != {b[f]!r}"
        else:
            assert np.isclose(a[f], b[f], rtol=1e-9, atol=1e-9), \
                f"{f}: {a[f]!r} != {b[f]!r}"


def _same_state(a, b):
    """Two sessions (either package; a live engine's ``session``)."""
    assert np.array_equal(a.partition.clique_of, b.partition.clique_of)
    assert np.array_equal(a.engine.state.E, b.engine.state.E)
    assert np.array_equal(a.engine.state.anchor, b.engine.state.anchor)


@pytest.fixture(scope="module")
def traces():
    ref = _ref_trace()
    return ref, _port(ref)


@pytest.fixture(scope="module")
def ref(traces):
    return ref_run_policy(_ref_policy(), traces[0], backend="numpy")


@pytest.fixture(scope="module")
def ref_session(traces):
    s = RefSession(_ref_policy(), traces[0].n, traces[0].m)
    s.feed_trace(traces[0])
    return s


# ---------------------------------------------------------------------------
# streamed parity against the offline replay
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk_size", [64, 333, 4096])
def test_live_matches_offline(traces, ref, ref_session, chunk_size):
    _, trace = traces
    eng = _live(trace, chunk_size=chunk_size)
    _stream(eng, trace)
    eng.drain()
    _same_costs(ref.costs, eng.costs)
    assert eng.partition.cliques == ref_session.partition.cliques
    _same_state(ref_session, eng.session)
    assert eng.policy.n_windows == ref.n_windows
    assert eng.compiles <= 2
    assert eng.in_flight == 0 and eng.pending == 0


def test_live_ttl_policy_matches_offline(traces):
    """Keep-or-not through the live path: the device's boundary evictions
    and the host engine's keep mask stay in step."""
    ref_tr, trace = traces
    off = ref_run_policy(_ref_policy("ttl"), ref_tr, backend="numpy")
    eng = _live(trace, "ttl", chunk_size=512)
    assert not eng._cgm
    _stream(eng, trace)
    eng.drain()
    _same_costs(off.costs, eng.costs)
    assert np.array_equal(eng.session.engine._item_keep,
                          eng.policy.item_keep())


# ---------------------------------------------------------------------------
# shape ratchets
# ---------------------------------------------------------------------------
def test_live_single_ratchet_and_warm_reuse(traces, ref):
    _, trace = traces
    cold = _live(trace, chunk_size=512)
    _stream(cold, trace)
    cold.drain()
    assert cold.compiles == 1 and cold.chunks == -(-trace.n_requests // 512)
    # a second engine in the same process, another slicing of the same
    # stream: the same chunks, one ratchet, the same totals
    warm = _live(trace, chunk_size=512)
    _stream(warm, trace, seed=11)
    warm.drain()
    assert warm.compiles == 1
    _same_costs(ref.costs, warm.costs)
    _same_costs(cold.costs, warm.costs, exact=True)


def test_feed_trace_chunked_matches_offline(traces, ref, ref_session):
    """The session's chunked ``feed_trace`` (one device replay a chunk,
    the host-schedule path pinned by a host CRM hook) equals the offline
    replay; a second session the same."""
    _, trace = traces
    hook = dict(crm_matmul=lambda H: H.T @ H)
    for _ in range(2):
        s = CacheSession(_policy(**hook), trace.n, trace.m, batch_size=512,
                         device="cpu")
        s.feed_trace(trace, chunk_size=512)
        assert s.replayer.last_stats["path"] == "host_schedule"
        _same_costs(ref.costs, s.costs)
        _same_state(ref_session, s)


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk_size,total,cut", [
    (1, 150, 73),          # every request its own chunk
    (7, 300, 151),         # chunks never align with submissions
    (64, 4000, 2503),
    (4096, 4000, 2503),    # one padded tail chunk
])
def test_midflight_snapshot_restores_bitwise(traces, chunk_size, total, cut):
    """A snapshot with chunks dispatched and a ragged remainder buffered
    restores into a fresh engine that finishes like an uninterrupted one,
    bit for bit (the buffer travels in the snapshot)."""
    trace = traces[1].slice(0, total)
    base = _live(trace, chunk_size=chunk_size)
    _stream(base, trace)
    base.drain()

    first = _live(trace, chunk_size=chunk_size)
    _stream(first, trace, hi=cut)
    snap = first.snapshot()              # not drained: the buffer rides
    second = _live(trace, chunk_size=chunk_size).restore(snap)
    assert second.pending == cut % chunk_size
    _stream(second, trace, lo=cut)
    second.drain()
    _same_costs(base.costs, second.costs, exact=True)
    _same_state(base.session, second.session)
    assert second.partition.cliques == base.partition.cliques
    assert second.policy.n_windows == base.policy.n_windows


def test_snapshot_interop_with_sessions(traces, ref):
    """Snapshots cross between the live engine and both packages'
    sessions, in both directions."""
    ref_tr, trace = traces
    cut = 2503
    live = _live(trace, chunk_size=512)
    _stream(live, trace, hi=cut)
    live.drain()
    snap = live.snapshot()
    for sess, tr in ((RefSession(_ref_policy(), trace.n, trace.m), ref_tr),
                     (CacheSession(_policy(), trace.n, trace.m,
                                   device="cpu"), trace)):
        sess.restore(snap)
        _same_state(live.session, sess)
        sess.feed(tr.items[cut:], tr.servers[cut:], tr.times[cut:])
        _same_costs(ref.costs, sess.costs)

    for sess, tr in ((RefSession(_ref_policy(), trace.n, trace.m), ref_tr),
                     (CacheSession(_policy(), trace.n, trace.m,
                                   device="cpu"), trace)):
        sess.feed(tr.items[:cut], tr.servers[:cut], tr.times[:cut])
        live2 = _live(trace, chunk_size=512).restore(sess.snapshot())
        _stream(live2, trace, lo=cut)
        live2.drain()
        sess.feed(tr.items[cut:], tr.servers[cut:], tr.times[cut:])
        _same_costs(sess.costs, live2.costs)
        _same_state(sess, live2.session)


# ---------------------------------------------------------------------------
# the serving surface
# ---------------------------------------------------------------------------
def test_futures_and_midstream_costs(traces, ref):
    ref_tr, trace = traces
    eng = _live(trace, chunk_size=256)
    cut = 1000
    fut = eng.submit(trace.items[:cut], trace.servers[:cut],
                     trace.times[:cut])
    assert eng.pending == cut % 256      # 3 chunks dispatched
    assert not fut.done()
    mid = eng.costs                      # dispatched chunks only
    assert mid.n_requests == cut - cut % 256
    got = fut.result()                   # dispatches the remainder
    assert fut.done()
    prefix = ref_run_policy(_ref_policy(), ref_tr.slice(0, cut),
                            backend="numpy")
    _same_costs(prefix.costs, got)
    _stream(eng, trace, lo=cut)
    _same_costs(ref.costs, eng.result().costs)


def test_out_of_order_submission_refused(traces, monkeypatch):
    _, trace = traces
    eng = _live(trace)
    eng.submit(trace.items[:10], trace.servers[:10], trace.times[:10])
    with pytest.raises(ValueError):
        eng.submit(trace.items[:5], trace.servers[:5],
                   trace.times[:5] - 100.0)
    assert eng.pending == 10
    with pytest.raises(ValueError):
        _live(trace, cgm="sometimes")
    # no silent CPU fallback: the default device is CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveServingEngine(_policy(), trace.n, trace.m)


# ---------------------------------------------------------------------------
# the device clique generation inside the serving loop
# ---------------------------------------------------------------------------
def test_live_cgm_force_matches_offline():
    ref_tr = _ref_trace(n_requests=1500)
    trace = _port(ref_tr)
    off = ref_run_policy(_ref_policy(), ref_tr, backend="numpy")
    eng = _live(trace, chunk_size=512, cgm="force")
    assert eng._cgm
    _stream(eng, trace)
    eng.drain()
    _same_costs(off.costs, eng.costs)
    sess = RefSession(_ref_policy(), trace.n, trace.m)
    sess.feed_trace(ref_tr)
    _same_state(sess, eng.session)
    assert eng.policy.n_windows == off.n_windows
    assert all(np.array_equal(a, b) for a, b in
               zip(sess.result().size_history, eng.result().size_history))
    with pytest.raises(ValueError, match="force"):
        _live(trace, "ttl", cgm="force")


def test_live_cgm_auto_routes_device():
    trace = _port(_ref_trace(n_requests=1500))
    eng = _live(trace, chunk_size=512)
    assert eng._cgm                      # auto: AKPC at a uniform dt
    _stream(eng, trace)
    eng.drain()
    assert eng.loop_stats["sync_merge"] > 0     # the device CGM ran
    # explicit off, a policy the device CGM does not run, a host CRM hook
    assert not _live(trace, cgm="off")._cgm
    assert not _live(trace, "ttl")._cgm
    assert not LiveServingEngine(
        _policy(crm_matmul=lambda H: H.T @ H), trace.n, trace.m,
        device="cpu")._cgm
    # a bucketed state keeps the device route (the CGM carry is dense-n);
    # row_sharded waits for the mesh
    assert _live(trace, layout="bucketed")._cgm
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        _live(trace, layout="row_sharded")


def test_serve_bench_holds_each_engine_to_offline():
    """The serving bench's scenario on the CPU at a small size: the
    session, a cold and a warm live engine each equal the offline replay
    before a time is kept (``bench_profile`` raises otherwise)."""
    rec = serve_bench.bench_profile("flash_crowd", 3000, "cpu")
    assert rec["device_cgm"] and rec["windows"] >= 2
    assert rec["ratchets_cold"] == rec["ratchets_warm"] == 1
    assert rec["session_s"] > 0 and rec["live_warm_s"] > 0


def test_live_sized_device_cgm_matches_offline():
    """The device clique generation with item sizes (the tiered model at a
    uniform dt): the carry's clique volumes and the sizes on the device,
    streamed, equal the offline replay."""
    from repro.core import CacheEnvironment as RefEnv

    from repro_torch.core import CacheEnvironment

    ref_tr = ref_synth_trace(RefSynthConfig(
        kind="netflix", n_items=60, n_servers=12, n_requests=2000,
        t_max=15.0, bundle_cover=1.0, bundle_zipf=0.7, seed=5,
        size_dist="lognormal"))
    trace = trace_from_arrays(ref_tr.items, ref_tr.servers, ref_tr.times,
                              ref_tr.n, ref_tr.m, sizes=ref_tr.sizes)
    off = ref_run_policy(
        _ref_policy(cost_model="tiered",
                    env=RefEnv.from_trace(ref_tr, RefParams())),
        ref_tr, backend="numpy")
    eng = LiveServingEngine(
        _policy(cost_model="tiered",
                env=CacheEnvironment.from_trace(trace, CostParams())),
        trace.n, trace.m, chunk_size=256, device="cpu")
    assert eng._cgm
    _stream(eng, trace)
    eng.drain()
    _same_costs(off.costs, eng.costs)
    assert eng.policy.n_windows == off.n_windows
