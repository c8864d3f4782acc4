"""Roofline table from the dry run's records (port of
``benchmarks/roofline_report.py``).

    PYTHONPATH=src python -m repro_torch.bench.roofline_report [--dryrun PATH]

Reads the JSONL that ``python -m repro_torch.launch.dryrun`` appends
(``REPRO_DRYRUN``, default ``experiments/dryrun_torch.jsonl``; the roofline
terms are against one H100's data-sheet peaks, ``launch.cost_analysis``)
and prints one row for each single-pod cell.  Nothing runs on a device.
"""
from __future__ import annotations

import argparse
import json
import os

from ..launch.dryrun import DEFAULT_OUT
from .common import emit, save_json


def load_records(path: str) -> list:
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return recs


def main(argv=None) -> list[tuple]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", default=os.environ.get("REPRO_DRYRUN",
                                                       DEFAULT_OUT))
    args = ap.parse_args(argv)
    rows = []
    recs = [r for r in load_records(args.dryrun) if r.get("mesh") == "single"]
    ok = [r for r in recs if r.get("status") == "ok"]
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"])):
        rows.append((
            f"roofline/{r['arch']}/{r['shape']}", 0,
            f"dom={r['dominant']};compute_s={r['compute_s']:.3g};"
            f"memory_s={r['memory_s']:.3g};collective_s={r['collective_s']:.3g};"
            f"useful={r['useful_flops_ratio']};frac={r['roofline_fraction']};"
            f"fits={r['fits_hbm']}"
        ))
    skipped = [r for r in recs if r.get("status") == "skipped"]
    for r in skipped:
        rows.append((f"roofline/{r['arch']}/{r['shape']}", 0,
                     "N/A(sub-quadratic-only)"))
    save_json("roofline_report_torch", {"n_ok": len(ok),
                                        "n_skipped": len(skipped)})
    emit(rows)
    return rows


if __name__ == "__main__":
    main()
