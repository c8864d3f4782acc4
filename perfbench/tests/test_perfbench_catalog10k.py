"""The ``catalog10k.serve-cgm`` cell: Fig. 9's 10,000-item catalog at
Table I prices through the live engine's device clique generation, and
the readers of Alg. 4's two edge-loop spans (``cgm.adjust.remove`` /
``cgm.adjust.add``).

On the CPU the cell's mix is cut (``helpers.small``): a run still takes
the device CGM at the cell's hot capacity (1,024 asked, 2,048 run), is
correct against the plain reference and reads both new metrics.  The
readers read their spans against the run's windows, and nothing (None,
never 0) without them, as on a program that lacks the spans."""
from __future__ import annotations

import json
import types

import numpy as np
import pytest

from perfbench import harness, readers, registry
from perfbench.tests.helpers import SECONDS, SEED, bench, small

CELL = "catalog10k.serve-cgm"
NEW = {"cgm.adjust_add_ms_per_window": "cgm.adjust.add",
       "cgm.adjust_remove_ms_per_window": "cgm.adjust.remove"}


def test_cell_resolves():
    cell = registry.cell(CELL)
    assert cell["config"]["name"] == "catalog10k"
    assert cell["traffic"] == registry.traffic("serve")
    assert cell["entry"]["chips"] == 1
    gen = cell["config"]["generator"]
    assert (gen["kind"], gen["n_items"], gen["n_servers"]) == (
        "spotify", 10_000, 600)
    assert "size_dist" not in gen
    assert cell["config"]["pricing"] == {"cost_model": "table1"}
    assert cell["workload"]["limits"] == {
        "cost_rel_gap": 1e-9, "count_gap": 0, "partition_gap": 0}
    listed = {m["name"] for m in registry.per_layer(registry.benchmark(),
                                                    CELL)}
    assert set(NEW) <= listed


def test_cut_run_takes_the_device_cgm_and_reads_the_new_metrics(capsys):
    """A pass of 4,096 requests spans a fifth of a T_CG window and the next
    pass starts a whole time unit later, so a boundary falls every pass or
    two: the window crosses one however slowly the CPU runs it."""
    b = bench()
    cell = small(CELL, b)
    cell["traffic"].update(requests=4096, chunk=2048, warmup_requests=4096)
    line = harness.run_cell(cell, b, SEED, 10 * SECONDS, True, device="cpu")
    counters = json.loads(next(
        ln for ln in capsys.readouterr().err.splitlines()
        if ln.startswith("counters "))[len("counters "):])
    assert counters["path"] == "device_cgm" and counters["windows"] >= 1
    stats = counters["loop_stats"]
    assert (stats["cgm_h"], stats["cgm_h_need"]) == (2048, 1024)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    assert set(NEW) <= set(line["metrics"])
    # the two phases lie inside cgm.adjust, itself inside cgm.boundary
    phases = sum(line["metrics"][m]["value"] for m in NEW)
    boundary = line["metrics"]["cgm.boundary_ms"]["value"]
    assert 0.0 < phases <= boundary * counters["windows"]


def _ctx(spans: dict, **counters) -> readers.Context:
    prof = types.SimpleNamespace(
        spans={k: np.asarray(v) for k, v in spans.items()}, device_time={},
        window_s=51.0, busy_s=5.0)
    return readers.Context(counters, prof, {})


SPANS = {"cgm.adjust.add": [0.030, 0.050], "cgm.adjust.remove": [0.010],
         "cgm.adjust": [0.2, 0.2], "cgm.sync.adjust": [0.001, 0.001]}


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_reads_its_span(metric):
    got = registry.reader(metric)(_ctx(SPANS, windows=4))
    want = float(np.sum(SPANS[NEW[metric]])) / 4 * 1e3
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_reads_nothing_without_its_span(metric):
    fn = registry.reader(metric)
    absent = {k: v for k, v in SPANS.items() if k != NEW[metric]}
    assert fn(_ctx(absent, windows=4)) is None
    assert fn(_ctx(dict(absent, **{NEW[metric]: []}), windows=4)) is None
    assert fn(_ctx(SPANS, windows=0)) is None
    assert fn(_ctx(SPANS)) is None
