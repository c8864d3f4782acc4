"""On the CPU, at a 20,000-request head (a sweep: 5,000-request traces),
the plain reference agrees with the program's plain path for each
cell's mix: the costs to float summation order, every counter and the
partition exactly."""
from __future__ import annotations

import pytest

from perfbench import harness, registry
from perfbench.tests.helpers import SECONDS, SEED, bench, cells, small

BENCH = bench()


@pytest.mark.parametrize("name", cells())
def test_reference_agrees(name):
    line = harness.run_cell(small(name, BENCH), BENCH, SEED, SECONDS, False,
                            device="cpu")
    c = line["checks"]
    assert line["correct"] is True
    assert c["cost_rel_gap"]["value"] < 1e-12
    assert c["count_gap"]["value"] == 0 and c["partition_gap"]["value"] == 0
    assert line["attempted"] > 0 and line["failed"] == 0
