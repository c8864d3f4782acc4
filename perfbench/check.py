"""How ``correct`` is decided: the program's outputs against the plain
reference's, over the same requests.

Three numbers, each the worst over the compared outputs:

* ``cost_rel_gap``: the largest relative gap of a float cost (transfer,
  caching, keepalive rent), against the reference's value;
* ``count_gap``: the largest gap of an integer counter (requests, item
  requests, misses, hits, items transferred), exact;
* ``partition_gap``: items whose clique differs from the reference's
  after the last window boundary, exact.

A run is correct when each is at or under the cell's limit
(``workloads/<cell>.json`` under ``"limits"``); ``PERF.md`` gives the
readings each limit was set from.
"""
from __future__ import annotations

import math

import numpy as np

FLOAT_FIELDS = ("transfer", "caching", "keepalive_rent")
INT_FIELDS = ("n_requests", "n_item_requests", "n_misses", "n_hits",
              "items_transferred")
NUMBERS = ("cost_rel_gap", "count_gap", "partition_gap")
#: the precision below each that the configuration can state: the control
LOWER = {"float64": "float32"}


def labels(clique_of) -> np.ndarray:
    """Each item's clique named by its smallest member (a partition's
    canonical form, whatever the clique ids)."""
    of = np.asarray(clique_of, np.int64)
    n = of.shape[0]
    low = np.full(int(of.max()) + 1 if n else 0, n, np.int64)
    np.minimum.at(low, of, np.arange(n, dtype=np.int64))
    return low[of]


def _rel(got: float, want: float) -> float:
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    if got == want:
        return 0.0
    return abs(got - want) / (abs(want) if want else 1.0)


def compare(pairs: list) -> dict:
    """``pairs``: (got costs, got labels, want costs, want labels), the
    costs as ``CostBreakdown.as_dict()``; the worst of each number."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for got, got_l, want, want_l in pairs:
        out["cost_rel_gap"] = max(out["cost_rel_gap"], *(
            _rel(float(got[f]), float(want[f])) for f in FLOAT_FIELDS))
        out["count_gap"] = max(out["count_gap"], *(
            float(abs(int(got[f]) - int(want[f]))) for f in INT_FIELDS))
        gap = (float(np.count_nonzero(got_l != want_l))
               if got_l.shape == want_l.shape else float(max(got_l.size,
                                                             want_l.size)))
        out["partition_gap"] = max(out["partition_gap"], gap)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the result line."""
    shown = {k: {"value": numbers[k], "limit": float(limits[k])}
             for k in NUMBERS}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
