"""A run whose timed path is broken underneath comes out not correct.

Each cell is driven as a run drives it (on the CPU, at a small size,
without the look for a card), with one fault planted in the program:

* ``state_unchanged``: a replay step returns the state it was given
  (``core.replay._replay_step`` does nothing, ``core.cgm._event_step``
  returns its carry);
* ``half_batch``: half of every batch left out and the costs taken over
  the rest scaled up to the whole (the live engine's chunks, the sweep's
  traces);
* ``answer_altered``: each answer the program produces (a cost
  breakdown) altered by one unit of transfer cost;
* ``lane_broken`` (the sweep's cells): the last lane of every laned
  replay scan loses its accumulated costs, the other lanes untouched.

One chip per cell: there is no exchange between chips to leave out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from perfbench import harness, registry
from perfbench.tests.helpers import SECONDS, SEED, bench, cells, small

BENCH = bench()


def _scaled(costs, k: float):
    c = dataclasses.replace(costs)
    for f in ("transfer", "caching", "keepalive_rent"):
        setattr(c, f, getattr(c, f) * k)
    for f in ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred"):
        setattr(c, f, int(getattr(c, f) * k))
    return c


def _plant(monkeypatch, fault: str) -> None:
    from repro_torch.core import cgm, replay, sweep
    from repro_torch.serving import live
    from repro_torch.traces.loader import Trace

    eng = live.LiveServingEngine
    if fault == "state_unchanged":
        monkeypatch.setattr(replay, "_replay_step", lambda *a, **k: None)
        monkeypatch.setattr(cgm, "_event_step", lambda carry, *a, **k: carry)
    elif fault == "half_batch":
        dispatch, sync, run = eng._dispatch, eng._sync_costs, sweep.SweepEngine.run

        def half_dispatch(self, items, servers, times):
            dispatch(self, items[::2], servers[::2], times[::2])
            self._dispatched_total += times.shape[0] - times[::2].shape[0]

        def half_run(self, points):
            halved = []
            for p in points:
                t = p.trace
                halved.append(dataclasses.replace(p, trace=Trace(
                    times=t.times[::2], servers=t.servers[::2],
                    items=t.items[::2], n=t.n, m=t.m, sizes=t.sizes)))
            return [dataclasses.replace(r, costs=_scaled(r.costs, 2.0))
                    for r in run(self, halved)]

        monkeypatch.setattr(eng, "_dispatch", half_dispatch)
        monkeypatch.setattr(eng, "_sync_costs",
                            lambda self: _scaled(sync(self), 2.0))
        monkeypatch.setattr(sweep.SweepEngine, "run", half_run)
    elif fault == "answer_altered":
        sync, run = eng._sync_costs, sweep.SweepEngine.run

        def altered(c):
            c = dataclasses.replace(c)
            c.transfer += 1.0
            return c

        monkeypatch.setattr(eng, "_sync_costs", lambda self: altered(sync(self)))
        monkeypatch.setattr(
            sweep.SweepEngine, "run",
            lambda self, pts: [dataclasses.replace(r, costs=altered(r.costs))
                               for r in run(self, pts)])
    elif fault == "lane_broken":
        for name in ("run_schedule", "run_schedules"):
            orig = getattr(replay, name)

            def last_lane_lost(*a, _orig=orig, **k):
                E, anchor, acc = _orig(*a, **k)
                if acc.dim() == 2 and acc.shape[0] > 1:
                    acc[-1].zero_()
                return E, anchor, acc

            monkeypatch.setattr(replay, name, last_lane_lost)
    else:
        raise KeyError(fault)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", cells())
def test_fault_is_not_correct(name, fault, monkeypatch):
    _plant(monkeypatch, fault)
    line = harness.run_cell(small(name, BENCH), BENCH, SEED, SECONDS, False,
                            device="cpu")
    assert line["correct"] is False, line["checks"]
    assert any(v["value"] > v["limit"] for v in line["checks"].values())
    assert np.isfinite(line["attempted"])


@pytest.mark.parametrize("name", [n for n in cells() if registry.cell(
    n, BENCH)["traffic"]["driver"] == "sweep"])
def test_one_lane_fault_is_not_correct(name, monkeypatch):
    _plant(monkeypatch, "lane_broken")
    line = harness.run_cell(small(name, BENCH), BENCH, SEED, SECONDS, False,
                            device="cpu")
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["cost_rel_gap"]["value"] > \
        line["checks"]["cost_rel_gap"]["limit"]
