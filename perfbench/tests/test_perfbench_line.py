"""The result line and the harness's refusals: the line carries the
contract's keys in order (``breakdown`` only when traced, ``checks``
last); with no card a run fails without a line and without falling back
to the CPU; a checkout without the program fails too."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness, registry
from perfbench.tests.helpers import ROOT, SECONDS, SEED, bench, small

BENCH = bench()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["netflix-t2.serve", "netflix-t2.sweep-fig6"])
def test_line_keys(name, trace):
    line = harness.run_cell(small(name, BENCH), BENCH, SEED, SECONDS,
                            bool(trace), device="cpu")
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    json.dumps(line)
    names = {m["name"] for m in (registry.per_layer(BENCH, name) if trace
                                 else registry.end_to_end(BENCH, name))}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    else:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "netflix-t2.serve",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_no_line():
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, {"PYTHONPATH": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_modules_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax", "repro"]
    monkeypatch.delitem(sys.modules, "repro")
    monkeypatch.delitem(sys.modules, "jax.numpy")
    assert "repro" not in harness.forbidden_modules()
