"""The harness finds every cell, mix, configuration and metric by name,
and ``BENCHMARK.json`` keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re

import pytest

from perfbench.tests.helpers import ROOT, bench, cells
from perfbench import registry

BENCH = registry.benchmark()
#: with the held-out cells' entries: their files are found by name too
ALL = bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("name", cells())
def test_cell_files_found(name):
    cell = registry.cell(name, ALL)
    assert cell["config"]["name"] == cell["workload"]["config"]
    registry.driver(cell["traffic"]["driver"])
    e2e = {m["name"] for m in registry.end_to_end(ALL, name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.per_layer(ALL, name)
    for key in cell["workload"]["limits"]:
        assert key in ("cost_rel_gap", "count_gap", "partition_gap")


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_metric_reader_found(metric):
    assert callable(registry.reader(metric))


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["name"] == c["name"]
        assert cfg["precision"]["state"] == "float64"
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("b", [BENCH, ALL], ids=["listed", "with_held"])
def test_workloads(b):
    seen = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))


@pytest.mark.parametrize("b", [BENCH, ALL], ids=["listed", "with_held"])
def test_metrics(b):
    names = set()
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for w in m.get("workloads", []):
            registry.cell(w, b)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  registry.end_to_end(b, w)}


def test_every_cell_file_listed_or_held():
    listed = set(cells(listed_only=True))
    held = {w["name"] for f in (ROOT / "perfbench" / "held").glob("*.json")
            for w in json.loads(f.read_text())["workloads"]}
    files = {f.stem for f in (ROOT / "perfbench" / "workloads").glob("*.json")}
    assert files == listed | held and not listed & held
