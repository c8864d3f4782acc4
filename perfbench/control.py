"""The control of a cell's correctness check.

    python3 perfbench/control.py --workload <cell> --seed <n> [--seed <n> ...] --extent <k>

The plain reference, computed in the precision below the one the
configuration states (float32 for its float64 state and cost sums), is
put in the program's place and judged by the cell's own comparison
against the float64 reference, over the first ``--extent`` requests of
the stream a run makes from the seed (a ``live_stream`` cell: as many
as a full-length run serves) or the first ``--extent`` sweeps (a
``sweep`` cell: its sample of points).  One JSON line a seed: the
numbers, their limits and ``correct``, which has to come out false.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control(cell: dict, seed: int, extent: int) -> dict:
    from perfbench import check, registry

    prec = cell["config"]["precision"]["state"]
    dtype = np.dtype(check.LOWER[prec])
    drv = registry.driver(cell["traffic"]["driver"])(
        cell, seed, tracing=False, device="cpu")
    drv.make_inputs()
    drv.served(extent)
    t0 = time.perf_counter()
    numbers = drv.check(dtype=dtype)
    correct, shown = check.verdict(numbers, cell["workload"]["limits"])
    return {"workload": cell["name"], "seed": seed, "extent": extent,
            "dtype": dtype.name, "correct": correct, "checks": shown,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--extent", type=int, required=True)
    args = ap.parse_args(argv)
    from perfbench import registry

    cell = registry.cell(args.workload)
    for seed in args.seed:
        print(json.dumps(control(cell, seed, args.extent)), flush=True)
    return 0


if __name__ == "__main__":
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
