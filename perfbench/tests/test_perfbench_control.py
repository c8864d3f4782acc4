"""The control of each cell's check comes out not correct: the plain
reference in float32 (the precision below the configurations' float64
state and cost sums), put in the program's place, fails the cell's own
limits against the float64 reference, at a size a test run holds.  And
the float64 reference gives the same answers however a stream is cut
into chunks, to float summation order."""
from __future__ import annotations

import pytest

from perfbench import check, registry
from perfbench.control import control
from perfbench.reference.akpc import AKPCConfig, ReferenceStream
from perfbench.reference.cost import CacheEnvironment, CostParams
from perfbench.synthetic import paper_trace
from perfbench.tests.helpers import SEED, bench, cells, small

BENCH = bench()


@pytest.mark.parametrize("name", cells())
def test_control_fails(name):
    cell = small(name, BENCH)
    extent = 3 if cell["traffic"]["driver"] == "sweep" else 60_000
    out = control(cell, SEED, extent)
    assert out["dtype"] == "float32"
    assert out["correct"] is False, out["checks"]


def test_float64_reference_is_chunking_free():
    t = paper_trace("netflix", 30_000, 7)
    cfg = AKPCConfig(CostParams(), 0.1)
    env = CacheEnvironment(t.n, t.m, CostParams())
    whole = ReferenceStream(cfg, env, "table1")
    whole.feed(t.items, t.servers, t.times)
    parts = ReferenceStream(cfg, env, "table1")
    for s in range(0, t.n_requests, 997):
        parts.feed(t.items[s:s + 997], t.servers[s:s + 997],
                   t.times[s:s + 997])
    gaps = check.compare([(
        parts.costs.as_dict(), check.labels(parts.partition.clique_of),
        whole.costs.as_dict(), check.labels(whole.partition.clique_of))])
    # batches that end elsewhere sum the costs in another order
    assert gaps["cost_rel_gap"] < 1e-13
    assert gaps["count_gap"] == 0 and gaps["partition_gap"] == 0
    assert whole.policy.n_windows > 10
