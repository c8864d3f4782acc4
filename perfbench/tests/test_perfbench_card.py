"""Each cell through the benchmark's command on the card, briefly: it
prints a correct result line.  Marked ``gpu``: it skips without a card
(decided in the fixture, not at import)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.tests.helpers import ROOT, SEED, cells


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells(listed_only=True))
def test_cell_on_card(card, name):
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
