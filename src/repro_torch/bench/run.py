"""The port's benchmark driver: one module per paper table or figure.

    python -m repro_torch.bench.run [suite] [--device cpu] [--smoke]

The port of ``benchmarks/run.py``, with its suite names: ``replay``,
``sweep``, ``table1``, ``fig5``, ``fig6``, ``fig7``, ``fig8``, ``fig9``,
``fig10``, ``kernels``, ``integration`` and ``roofline``, in that order
(all of them without ``suite``).  Each prints ``name,us_per_call,derived`` CSV rows,
writes its JSON payload under ``REPRO_RESULTS`` and runs on ``--device``
(default CUDA, raising without it).  ``--smoke`` runs each suite at its
smoke size (the suite's own ``--smoke`` where it has one, 3,000 requests
for fig5 and fig6, the small kernel-bench shapes).  A suite that fails
its gate fails the run.  ``roofline`` reads the dry run's records
(``python -m repro_torch.launch.dryrun``; ``REPRO_DRYRUN``) and runs on no
device.  Budget knobs (env): ``REPRO_BENCH_REQUESTS`` (fig5),
``REPRO_BENCH_SWEEP_REQUESTS`` (a sweep point).
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time

#: (suite, module) in the reference's order
SUITES = (
    ("replay", "replay_bench"),
    ("sweep", "sweep_bench"),
    ("table1", "table1"),
    ("fig5", "fig5"),
    ("fig6", "fig6"),
    ("fig7", "fig7"),
    ("fig8", "fig8"),
    ("fig9", "fig9"),
    ("fig10", "fig10"),
    ("kernels", "kernel_bench"),
    ("integration", "integration_bench"),
    ("roofline", "roofline_report"),
)
#: each suite's arguments at its smoke size
SMOKE_ARGS = {
    "replay": ["--smoke"], "sweep": ["--smoke"], "fig7": ["--smoke"],
    "fig8": ["--smoke"], "fig9": ["--smoke"], "fig10": ["--smoke"],
    "fig5": ["--requests", "3000"], "fig6": ["--requests", "3000"],
    "kernels": ["--big-requests", "256", "--big-slots", "98"],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("suite", nargs="?", default=None,
                    choices=[name for name, _ in SUITES])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without it) or cpu")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    failed = []
    for name, module in SUITES:
        if args.suite and args.suite != name:
            continue
        mod = importlib.import_module(f"{__package__}.{module}")
        argv_s = (SMOKE_ARGS.get(name, []) if args.smoke else [])
        if args.device is not None and name not in ("table1", "roofline"):
            argv_s = argv_s + ["--device", args.device]
        t0 = time.time()
        rc = mod.main(argv_s)
        ok = not isinstance(rc, int) or rc == 0
        print(f"suite/{name},{int((time.time() - t0) * 1e6)},"
              f"{'done' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(name)
    if failed:
        print(f"FAILED suites: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
