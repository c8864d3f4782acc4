"""Finds a cell's files by the names in ``BENCHMARK.json``.

* ``configs/<name>.json``: a deployment (generator, pricing, policy);
* ``traffic/<name>.json``: a traffic mix, read by the driver it names;
* ``workloads/<cell>.json``: a cell's configuration, mix, chips, policy
  overrides, precision and correctness limits;
* ``metrics/<name>.py``: one reader a per-layer metric, ``read(ctx)``
  returning a number or None;
* ``drivers/<name>.py``: the window drivers the mixes name.

A later change adds a cell or a metric by adding files and an entry in
``BENCHMARK.json``; nothing here names a cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def workload_file(name: str) -> dict:
    return _json("workloads", name)


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's ``BENCHMARK.json`` entry merged with its workload file,
    configuration and mix; the two files must agree on config, mix and
    chips."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = workload_file(name)
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {wl[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return {"name": name, "workload": wl, "config": config(wl["config"]),
            "traffic": traffic(wl["traffic"]), "entry": entry}


def _reports(metric: dict, cell_name: str) -> bool:
    listed = metric.get("workloads")
    return listed is None or cell_name in listed


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if _reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those listing it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def reader(metric_name: str):
    """``metrics/<name>.py``'s ``read`` (a name may hold dots, so the file
    is loaded by path)."""
    path = HERE / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for metric {metric_name!r}")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """``drivers/<name>.py``'s ``Driver`` class."""
    return importlib.import_module(f"perfbench.drivers.{name}").Driver
