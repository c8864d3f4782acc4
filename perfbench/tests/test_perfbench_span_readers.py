"""The readers of the program's own spans on a made-up trace: each reads
its span against its base (windows, chunks, requests), and reads nothing
(None, never 0) where the trace has no such span, as on a program that
lacks it."""
from __future__ import annotations

import types

import numpy as np
import pytest

from perfbench import readers, registry

#: every span the readers below read, with made-up seconds
SPANS = {
    "live.build": [0.010, 0.030],
    "cgm.sync.adjust": [0.001, 0.002],
    "cgm.sync.split": [0.003],
    "cgm.sync.merge": [0.004, 0.005, 0.005],
    "host_cgm.window_crm": [0.3, 0.5],
    "host_cgm.cliques": [0.2, 0.2],
    "host_cgm.upload": [0.1, 0.3],
    "host.lookup": [0.25, 0.75],
    # spans no new reader reads: never counted by the readers below
    "cgm.boundary": [9.0],
    "perfbench.window": [51.0],
}
COUNTERS = {"windows": 4, "requests": 2_000_000, "chunks": 2}

#: (metric, the value SPANS and COUNTERS give it, the spans it reads)
CASES = [
    ("live.build_ms_per_chunk", 20.0, ("live.build",)),
    ("cgm.sync_ms_per_window", 20.0 / 4,
     ("cgm.sync.adjust", "cgm.sync.split", "cgm.sync.merge")),
    ("host_cgm.crm_ms_per_window", 800.0 / 4, ("host_cgm.window_crm",)),
    ("host_cgm.cliques_ms_per_window", 400.0 / 4, ("host_cgm.cliques",)),
    ("host_cgm.upload_ms_per_window", 400.0 / 4, ("host_cgm.upload",)),
    ("host.lookup_s_per_mreq.serve", 1.0 / 2, ("host.lookup",)),
]


def _ctx(spans: dict, **counters) -> readers.Context:
    prof = types.SimpleNamespace(
        spans={k: np.asarray(v) for k, v in spans.items()}, device_time={},
        window_s=51.0, busy_s=5.0)
    return readers.Context(counters, prof, {})


@pytest.mark.parametrize("metric,want,_", CASES, ids=[c[0] for c in CASES])
def test_reads_its_spans(metric, want, _):
    got = registry.reader(metric)(_ctx(SPANS, **COUNTERS))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric,_,read", CASES, ids=[c[0] for c in CASES])
def test_nothing_to_read(metric, _, read):
    """Without its spans (the parent's trace), or with them empty, a reader
    returns None; other spans do not stand in for them."""
    fn = registry.reader(metric)
    absent = {k: v for k, v in SPANS.items() if k not in read}
    assert fn(_ctx(absent, **COUNTERS)) is None
    empty = dict(absent, **{k: [] for k in read})
    assert fn(_ctx(empty, **COUNTERS)) is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES
                                    if c[0] != "live.build_ms_per_chunk"])
def test_no_base_reads_nothing(metric):
    """A run that counted no window (or served nothing) has no base."""
    got = registry.reader(metric)(_ctx(SPANS, windows=0, requests=0))
    assert got is None


def test_listed_in_their_cells():
    """Each reader is listed for the cells whose path opens its span."""
    cells = {m["name"]: m.get("workloads") for m in
             registry.benchmark()["per_layer"]}
    for metric, _, read in CASES:
        want = (["netflix-t2.serve"] if read[0].startswith(("live.", "cgm."))
                else ["catalog10k-hetero.serve"])
        assert cells[metric] == want, metric
