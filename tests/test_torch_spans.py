"""The port's named host spans (``repro_torch.spans``) on the CPU.

* :func:`~repro_torch.spans.span` is one shared do-nothing context when no
  profiler runs, and a ``torch.profiler`` range when one does;
* the live engine's device-CGM path: one ``live.dispatch`` a chunk, its
  ``live.build`` / ``live.stage`` inside it, one ``cgm.sync.<kind>``
  span for every sync ``loop_stats`` counts, each inside a
  ``cgm.boundary``, and Alg. 4's ``cgm.adjust.remove`` / ``.add`` once a
  boundary inside ``cgm.adjust``, holding its syncs; the hot capacity
  counters ``cgm_h`` / ``cgm_h_need``;
* its host-schedule path under AKPC: one ``host_cgm.window_crm`` and one
  ``host_cgm.cliques`` a window, inside the policy's ``cg_seconds``, and
  one ``host.lookup`` a lookup call;
* the host CGM hooks: one ``host_cgm.upload`` and one
  ``host_cgm.readback`` a call, and through ``crm_matmul``'s id entry the
  device build of H between them (``host_cgm.incidence``);
* tracing changes no cost and no partition;
* on the card (``gpu``): a submit that waited on the ring counts its
  seconds in ``loop_stats["ring_wait_s"]``.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import CostParams, build_window_crm, get_policy
from repro_torch.kernels.autowire import cgm_hooks
from repro_torch.serving import LiveServingEngine
from repro_torch.spans import span
from repro_torch.traces.synthetic import SynthConfig, synth_trace

T_CG = 0.73                  # never divides the grids: windows split chunks
SLICE = 128


@pytest.fixture(scope="module")
def trace():
    return synth_trace(SynthConfig(
        kind="netflix", n_items=60, n_servers=12, n_requests=2000,
        t_max=15.0, bundle_cover=1.0, bundle_zipf=0.7, seed=3))


def _engine(trace, cgm, device="cpu", policy="akpc", **kw):
    pol = (get_policy("akpc", params=CostParams(), t_cg=T_CG, top_frac=1.0)
           if policy == "akpc" else get_policy(policy, params=CostParams()))
    kw.setdefault("chunk_size", 512)
    return LiveServingEngine(pol, trace.n, trace.m, cgm=cgm, device=device,
                             **kw)


def _serve(eng, trace):
    for s in range(0, trace.n_requests, SLICE):
        e = s + SLICE
        eng.submit(trace.items[s:e], trace.servers[s:e], trace.times[s:e])
    eng.drain()
    return eng


def _traced(fn):
    """``fn()`` under the CPU profiler; returns (its result, the host
    spans as (name, start_ns, end_ns))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.is_user_annotation()]
    return out, spans


def _named(spans, name):
    return [sp for sp in spans if sp[0] == name]


def _inside(inner, outers) -> bool:
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


def test_span_is_shared_null_without_profiler_and_records_under_it():
    a, b = span("x.a"), span("x.b")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a:
        pass

    def work():
        with span("x.outer"):
            with span("x.inner"):
                torch.ones(4).sum()
        return span("x.c")

    ctx, spans = _traced(work)
    assert not isinstance(ctx, contextlib.nullcontext)
    (outer,), (inner,) = _named(spans, "x.outer"), _named(spans, "x.inner")
    assert _inside(inner, [outer])


def test_device_cgm_spans_nest_and_match_the_sync_counts(trace):
    eng, spans = _traced(lambda: _serve(_engine(trace, "force"), trace))
    assert eng._cgm
    dispatch = _named(spans, "live.dispatch")
    assert len(dispatch) == eng.chunks > 1
    for name in ("live.build", "live.stage"):
        inner = _named(spans, name)
        assert len(inner) == eng.chunks
        assert all(_inside(sp, dispatch) for sp in inner)
    kinds = {k[len("sync_"):]: v for k, v in eng.loop_stats.items()
             if k.startswith("sync_")}
    assert set(kinds) == {"adjust", "split", "merge"}
    assert all(v > 0 for v in kinds.values())
    named = {sp[0][len("cgm.sync."):] for sp in spans
             if sp[0].startswith("cgm.sync.")}
    assert named == set(kinds)
    boundary = _named(spans, "cgm.boundary")
    for kind, count in kinds.items():
        syncs = _named(spans, "cgm.sync." + kind)
        assert len(syncs) == count, kind
        assert all(_inside(sp, boundary) for sp in syncs)
    # Alg. 4's two edge phases: once a boundary each, inside cgm.adjust,
    # and every adjust sync inside one of them
    adjust = _named(spans, "cgm.adjust")
    assert len(adjust) == len(boundary) > 0
    phases = []
    for name in ("cgm.adjust.remove", "cgm.adjust.add"):
        phase = _named(spans, name)
        assert len(phase) == len(boundary), name
        assert all(_inside(sp, adjust) for sp in phase)
        phases += phase
    assert all(_inside(sp, phases)
               for sp in _named(spans, "cgm.sync.adjust"))
    assert eng.loop_stats["cgm_h"] == eng._cgm_dims["h"]
    assert 0 < eng.loop_stats["cgm_h_need"] <= eng.loop_stats["cgm_h"]
    assert not [sp for sp in spans if sp[0].startswith("cgm_lanes.")]


def test_host_cgm_spans_count_windows_and_lookups(trace):
    eng, spans = _traced(lambda: _serve(_engine(trace, "off"), trace))
    assert not eng._cgm
    pol = eng.policy
    assert pol.n_windows > 1
    crm, cliques = (_named(spans, "host_cgm.window_crm"),
                    _named(spans, "host_cgm.cliques"))
    assert len(crm) == len(cliques) == pol.n_windows
    spanned_s = sum(e - s for _, s, e in crm + cliques) * 1e-9
    assert 0.0 < spanned_s <= pol.cg_seconds
    for name in ("host_cgm.adjust", "host_cgm.split", "host_cgm.merge"):
        phase = _named(spans, name)
        assert len(phase) == pol.n_windows
        assert all(_inside(sp, cliques) for sp in phase)
    lookups = _named(spans, "host.lookup")
    assert len(lookups) == eng._lookup.calls > 0
    dispatch = _named(spans, "live.dispatch")
    assert len(dispatch) == eng.chunks
    assert all(_inside(sp, _named(spans, "live.build"))
               for sp in crm + lookups)
    assert all(_inside(sp, dispatch) for sp in _named(spans, "live.stage"))


@pytest.mark.parametrize("hook", ["crm_matmul", "pair_edges", "crm_ids"])
def test_cgm_hooks_span_one_upload_and_one_readback(hook):
    """``crm_ids``: Alg. 2 through the hook's id entry, its ids' upload,
    the device build of H (``host_cgm.incidence``) and the read-back one
    span each, in that order."""
    crm_matmul, pair_edges = cgm_hooks("cpu")
    rng = np.random.default_rng(0)
    H = (rng.random((40, 12)) < 0.3).astype(np.float32)
    A = (rng.random((12, 12)) < 0.4).astype(np.float32)
    A = np.triu(A, 1) + np.triu(A, 1).T
    M = (rng.random((6, 12)) < 0.3).astype(np.float32)
    items = rng.integers(-1, 12, size=(40, 5)).astype(np.int32)
    if hook == "crm_matmul":
        out, spans = _traced(lambda: crm_matmul(H))
        want = H.T @ H
        np.fill_diagonal(want, 0.0)        # the CRM has no self pairs
    elif hook == "crm_ids":
        got, spans = _traced(lambda: build_window_crm(
            items, 12, 0.2, 1.0, crm_matmul=crm_matmul))
        out, want = got.raw, build_window_crm(items, 12, 0.2, 1.0).raw
        assert crm_matmul.id_windows == 1
    else:
        out, spans = _traced(lambda: pair_edges(M, A))
        want = M @ A @ M.T
    assert np.array_equal(out, want)
    assert len(_named(spans, "host_cgm.upload")) == 1
    assert len(_named(spans, "host_cgm.readback")) == 1
    if hook == "crm_ids":
        (up,), (inc,), (back,) = (_named(spans, name) for name in (
            "host_cgm.upload", "host_cgm.incidence", "host_cgm.readback"))
        assert up[2] <= inc[1] and inc[2] <= back[1]


@pytest.mark.parametrize("cgm", ["force", "off"])
def test_tracing_changes_no_cost_and_no_partition(trace, cgm):
    plain = _serve(_engine(trace, cgm), trace)
    traced, _ = _traced(lambda: _serve(_engine(trace, cgm), trace))
    assert plain.costs.as_dict() == traced.costs.as_dict()
    assert np.array_equal(plain.partition.clique_of,
                          traced.partition.clique_of)
    assert plain.policy.n_windows == traced.policy.n_windows


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ring_wait_seconds_counted(cuda_device, trace, monkeypatch):
    """A stream slowed on the card (``torch.cuda._sleep`` of ~0.2 s before
    each chunk's uploads, far longer than the host's traced build of a
    chunk) fills the ring of the host-schedule path: every wait is counted
    and spanned, and its seconds are summed in ``ring_wait_s``."""
    stage = LiveServingEngine._stage

    def slow_stage(self, arrays):
        torch.cuda._sleep(400_000_000)
        return stage(self, arrays)

    monkeypatch.setattr(LiveServingEngine, "_stage", slow_stage)
    eng, spans = _traced(lambda: _serve(
        _engine(trace, "off", cuda_device, "no_packing", chunk_size=256,
                ring=2), trace))
    assert eng.ring_waits > 0
    assert eng.loop_stats["ring_wait_s"] > 0.0
    waits = _named(spans, "live.ring_wait")
    assert len(waits) == eng.ring_waits
    assert all(_inside(sp, _named(spans, "live.stage")) for sp in waits)
