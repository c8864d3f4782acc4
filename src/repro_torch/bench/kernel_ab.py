"""Device times of ``crm_update`` and ``packed_lookup`` where their copy and
count paths meet, so that two checkouts of the port can be compared on
one card in one call.

Run it from a checkout, with the ``src`` of the checkout to time first on
``PYTHONPATH`` (this file uses nothing of the package but the wrappers,
their plain versions and ``common.cuda_graph_time``, so it runs against an
older checkout too)::

    PYTHONPATH=src python3 src/repro_torch/bench/kernel_ab.py --tag change

Each case is made from ``--seed`` on the card and held bitwise against its
plain version, then timed on the card alone by
:func:`common.cuda_graph_time` (a CUDA graph of ``calls`` calls, the mean of
3 replays) ``--rounds`` times; a gather's ``index_select`` is timed right
after the kernel in each round, as ``kernel_bench.device_times`` does.
The cases: ``crm_update`` on H of up to 5 ones a row (the leading h columns
of an (L, rows, h + 1) buffer, as the device clique generation passes it)
at the serving expert cache's 192 x 40, at 992 and 993 rows of 17 lanes of
h 60 and at fig7's 17 x 23,104 x 60, then (after the gathers) at the row
counts of :data:`CROSS_CASES`; ``packed_lookup`` of distinct,
unsorted ids at the expert gathers' shapes (7.9 MB bf16 rows at C 10, R 7
and C 8, R 8; 23.6 MB float16 at C 34, R 2; deepseek-v2's 78.6 MB bf16
at C 69, R 18).  Prints one JSON object with the card's name and power
limit and writes it to ``<--out>/kernel_ab_<tag>.json`` (default
``smoke_out/``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import numpy as np
import torch

from repro_torch.bench.common import cuda_graph_time
from repro_torch.kernels.crm_update import crm_update, crm_update_plain
from repro_torch.kernels.packed_lookup import packed_lookup, packed_lookup_plain

#: (lanes, rows, h) of the crm_update cases
CRM_CASES = ((1, 192, 40), (17, 992, 60), (17, 993, 60), (17, 23_104, 60))
#: the same after the gathers, for where ``mid`` and ``wide`` cross: one
#: lane of h 40 and 17 of h 60 at rows up to the wide grid's two a warp
CROSS_CASES = ((1, 1024, 40), (1, 2048, 40), (1, 4224, 40), (1, 8448, 40),
               (1, 16_896, 40), (17, 62, 60), (17, 124, 60), (17, 248, 60),
               (17, 496, 60))
#: (label, C, R, omega, row elements an expert, dtype) of the gathers
GATHER_CASES = (
    ("serve_model 7.9 MB, C 10, R 7", 10, 7, 5, 1536 * 512, torch.bfloat16),
    ("serve_model 7.9 MB, C 8, R 8", 8, 8, 5, 1536 * 512, torch.bfloat16),
    ("expert_cache 23.6 MB, C 34, R 2", 34, 2, 5, 3 * 1536 * 512,
     torch.float16),
    ("deepseek-v2 78.6 MB, C 69, R 18", 69, 18, 5, 5120 * 1536,
     torch.bfloat16),
)
CRM_CALLS = 100
GATHER_CALLS = 10


def crm_input(rng, lanes: int, rows: int, h: int, dev) -> torch.Tensor:
    """The leading h columns of a (lanes, rows, h + 1) 0/1 buffer with up to
    5 ones a row (2-D at one lane)."""
    buf = np.zeros((lanes, rows, h + 1), np.float32)
    cols = rng.integers(0, h + 1, size=(lanes, rows, 5))
    np.put_along_axis(buf, cols, 1.0, axis=2)
    H = torch.from_numpy(buf).to(dev)[:, :, :h]
    return H[0] if lanes == 1 else H


def crm_records(rng, cases, rounds: int, dev) -> list[dict]:
    """Each (lanes, rows, h) case held bitwise and timed ``rounds`` times."""
    recs = []
    for lanes, rows, h in cases:
        H = crm_input(rng, lanes, rows, h, dev)
        if not torch.equal(crm_update(H), crm_update_plain(H)):
            raise AssertionError(f"crm_update differs at {lanes}x{rows}x{h}")
        recs.append({
            "lanes": lanes, "rows": rows, "h": h,
            "path": getattr(crm_update, "last_path", None),
            "device_ms": [cuda_graph_time(lambda: crm_update(H), CRM_CALLS)
                          for _ in range(rounds)]})
    return recs


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="smoke_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    out = {"tag": args.tag, "card": card(), "crm_update": [],
           "packed_lookup": []}
    out["crm_update"] += crm_records(rng, CRM_CASES, args.rounds, dev)
    for label, C, R, omega, d, dtype in GATHER_CASES:
        g = torch.Generator(device=dev)
        g.manual_seed(int(rng.integers(1 << 30)))
        table = torch.randint(-(1 << 15), 1 << 15, (C, omega, d),
                              generator=g, device=dev,
                              dtype=torch.int16).view(dtype)
        ids = torch.tensor(rng.choice(C, R, replace=False), dtype=torch.int32,
                           device=dev)

        def kern():
            return packed_lookup(table, ids, ids_checked=True)

        def lib():
            return table.index_select(0, ids.to(torch.int64))

        if not torch.equal(kern().view(torch.int16),
                           packed_lookup_plain(table, ids).view(torch.int16)):
            raise AssertionError(f"packed_lookup differs at {label}")
        rec = {"label": label, "path": packed_lookup.last_path,
               "row_bytes": omega * d * table.element_size(),
               "device_ms": [], "library_device_ms": []}
        for _ in range(args.rounds):
            rec["device_ms"].append(cuda_graph_time(kern, GATHER_CALLS))
            rec["library_device_ms"].append(cuda_graph_time(lib,
                                                            GATHER_CALLS))
        out["packed_lookup"].append(rec)
        del table
        torch.cuda.empty_cache()
    out["crm_update"] += crm_records(rng, CROSS_CASES, args.rounds, dev)
    line = json.dumps(out)
    print(line)
    dest = pathlib.Path(args.out) / f"kernel_ab_{args.tag}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(line + "\n")


if __name__ == "__main__":
    main()
