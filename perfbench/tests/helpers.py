"""Shared pieces of the benchmark's tests: the program on the module path,
each cell cut to a size the CPU runs in seconds (the cells' own sizes
run only on the card), and the cells held out of ``BENCHMARK.json``
(``perfbench/held/``), whose files the benchmark keeps and the tests
drive too."""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import registry  # noqa: E402

#: a seed above 32 signed bits, as the driver's are
SEED = 2**31 + 12345
#: the window of a CPU run, seconds
SECONDS = 0.5


def small(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` with its mix cut for the CPU."""
    cell = registry.cell(name, bench)
    mix = cell["traffic"]
    if mix["driver"] == "live_stream":
        mix.update(requests=20_000, chunk=4096, warmup_requests=8192)
    else:
        mix.update(requests=5000, pool=2, alphas=[0.6, 1.0, 4],
                   rhos=[1.0, 6.0, 2])
    return cell


def bench() -> dict:
    """``BENCHMARK.json`` with the entries of each held-out cell added."""
    b = registry.benchmark()
    for f in sorted((ROOT / "perfbench" / "held").glob("*.json")):
        held = json.loads(f.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            b[key] = b[key] + held[key]
    return b


def cells(listed_only: bool = False) -> list[str]:
    """Every cell the tests drive, or only those ``BENCHMARK.json`` lists."""
    b = registry.benchmark() if listed_only else bench()
    return [w["name"] for w in b["workloads"]]
