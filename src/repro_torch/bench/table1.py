"""Table I on the port: transfer and caching costs of packed against
unpacked bundles.

    python -m repro_torch.bench.table1

The port of ``benchmarks/table1_cost_model.py``, built through the port's
cost-model registry: the ``table1`` model is Table I, and the ``tiered``
model at its default schedule (one breakpoint at volume 1, marginal rate
alpha) must reproduce it exactly on unit sizes, which is checked.  The
payload lands in ``table1_cost_model_torch.json`` under ``REPRO_RESULTS``.
Pure host arithmetic: nothing runs on the card.
"""
from __future__ import annotations

import argparse
import sys

from ..core import CacheEnvironment, CostParams, get_cost_model
from .common import emit, save_json

BUNDLES = (1, 2, 3, 5)


def table() -> tuple[dict, list]:
    """``{k: {unpacked, packed, caching}}`` and the CSV rows."""
    env = CacheEnvironment(n=8, m=1, params=CostParams())
    model = get_cost_model("table1", env)
    tiered = get_cost_model("tiered", env)     # default = alpha-linear
    dt = float(model.dt()[0])
    rows, payload = [], {}
    for k in BUNDLES:
        unp = model.transfer_cost(k, packed=False)
        pkd = model.transfer_cost(k, packed=True)
        cache = model.caching_cost(k, dt)
        if tiered.transfer_cost(k, packed=True) != pkd:
            raise RuntimeError(
                "tiered default must reproduce Table I (alpha-linear tier)")
        payload[k] = {"unpacked": unp, "packed": pkd, "caching": cache}
        rows.append((f"table1/k={k}", 0,
                     f"unpacked={unp};packed={round(pkd, 3)};"
                     f"caching={cache}"))
    return payload, rows


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    payload, rows = table()
    save_json("table1_cost_model_torch", payload)
    emit(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
