"""Kernel benchmark of the port: every row of the reference's
``benchmarks/kernel_bench.py``, on the card.

    python -m repro_torch.bench.kernel_bench [--device cuda] [--big-requests 65536]

Rows, at the reference's shapes and inputs (numpy seed 0, drawn in the
reference's order):

* ``crm_update`` at B x n = 200 x 60, 2000 x 600 and 8000 x 1024;
* ``clique_pair_edges`` at k x n = 60 x 60 and 200 x 512;
* ``packed_lookup`` against ``unpacked_lookup`` at omega 5, d 256, R 64,
  C 128, float32: the paper's packed transfer in memory-system form, one
  copy per clique (R copy units) against one per item (R omega);

and one lookup pair where bytes matter: C 10,000 cliques (catalog-10k's
n), omega 5, d 256, float32, R 65,536 (a 51 MB table, a 335 MB output).

Each row holds the kernel against its plain version bit for bit (the two
lookups also against each other: the same bytes, packed and unpacked)
and reports, on the card, the kernel's time, the plain version's, one
PyTorch call's (``H.T @ H``, ``M @ A @ M.T``, ``index_select``; TF32 off)
and the bound, all in ms by CUDA events after a warm-up.  The bound is
the larger of the bytes the inputs need (for a lookup: the ids, each
table row they touch read once, the output written once) at 3.35 TB/s
and the products' multiply-adds at these inputs at the TF32 peak.  With
``--device cpu`` the wrappers run their plain versions and only the
checks run: no time is taken on the CPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import common
from .common import PEAK_FP32, PEAK_TF32, bound, cuda_time, product_ops
from .. import kernels
from ..kernels import ops

#: reference shapes: CRM (B, n), density (k, n), lookup (omega, d, R, C)
CRM_SHAPES = ((200, 60), (2000, 600), (8000, 1024))
DENSITY_SHAPES = ((60, 60), (200, 512))
LOOKUP = (5, 256, 64, 128)
#: the lookup pair where bytes matter: C cliques, R requests
BIG_C, BIG_R = 10_000, 65_536


def _record(name, shape, kern, plain, lib, bnd, dev, reps, **extra) -> dict:
    """Hold ``kern()`` bitwise against ``plain()``; on the card, time the
    kernel, the plain version and the library call."""
    got, want = kern(), plain()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        err = float((got.double() - want.double()).abs().max())
        raise AssertionError(f"{name} {shape} differs from its plain version: "
                             f"max abs err {err}")
    rec = {"name": name, "shape": shape, "equal": True, "max_abs_err": 0.0,
           **bnd, **extra}
    if dev.type == "cuda":
        rec.update(ms=cuda_time(kern, reps), plain_ms=cuda_time(plain, reps),
                   library_ms=cuda_time(lib, reps))
    else:
        rec.update(ms=None, plain_ms=None, library_ms=None)
    return rec


def _lookup_pair(label, table, cids, dev, reps) -> list[dict]:
    """packed_lookup of ``table`` at ``cids`` against unpacked_lookup of
    the same bytes as item rows at the cliques' item ids."""
    C, omega, d = table.shape
    R = int(cids.shape[0])
    items = table.reshape(C * omega, d)
    iids = (cids[:, None] * omega
            + torch.arange(omega, dtype=torch.int32, device=dev)[None, :])
    iids = iids.to(torch.int32).contiguous()
    elem = table.element_size()
    shape = {"C": C, "omega": omega, "d": d, "R": R, "dtype": str(table.dtype)}
    # bytes these ids need: the ids, each table row they touch read once,
    # the output written once
    rows = int(torch.unique(cids).numel())
    out_bytes = float(R * omega * d * elem)
    # the ids are checked once here; the timed calls skip the check (a
    # device -> host read of the ids' range)
    got_u = ops.gather_unpacked(items, iids)
    got_p = ops.gather_packed(table, cids)
    if not torch.equal(got_u, got_p):
        raise AssertionError(f"unpacked_lookup differs from packed_lookup on "
                             f"the same bytes at {label}")
    packed = _record(
        "packed_lookup", {**shape, "config": label},
        lambda: ops.gather_packed(table, cids, ids_checked=True),
        lambda: kernels.packed_lookup_plain(table, cids),
        lambda: table.index_select(0, cids),
        bound(0.0, PEAK_FP32, 4.0 * R + rows * omega * d * elem + out_bytes),
        dev, reps, copy_units=R, bytes_per_unit=omega * d * elem)
    unpacked = _record(
        "unpacked_lookup", {**shape, "config": label},
        lambda: ops.gather_unpacked(items, iids, ids_checked=True),
        lambda: kernels.unpacked_lookup_plain(items, iids),
        lambda: items.index_select(0, iids.reshape(-1)),
        bound(0.0, PEAK_FP32,
              4.0 * R * omega + rows * omega * d * elem + out_bytes),
        dev, reps, copy_units=R * omega, bytes_per_unit=d * elem)
    packed["equal_unpacked"] = unpacked["equal_packed"] = True
    return [packed, unpacked]


def run(device=None, *, big_requests: int = BIG_R, reps: int = 20
        ) -> list[dict]:
    """Every row of the benchmark on ``device`` (default CUDA); returns
    the records, raising if a kernel differs from its plain version."""
    from ..core.replay import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    recs = []
    for B, n in CRM_SHAPES:
        H_np = (rng.random((B, n)) < 0.03).astype(np.float32)
        H = torch.from_numpy(H_np).to(dev)
        if not np.array_equal(ops.crm_matmul(H_np, device=dev),
                              kernels.crm_update_plain(H).cpu().numpy()):
            raise AssertionError(f"ops.crm_matmul differs at B={B} n={n}")
        recs.append(_record(
            "crm_update", {"B": B, "n": n},
            lambda: kernels.crm_update(H), lambda: kernels.crm_update_plain(H),
            lambda: H.T @ H,
            bound(product_ops(H.T, H), PEAK_TF32, 4.0 * (B * n + n * n)),
            dev, reps, mxu_tiles=(-(-n // 128)) ** 2 * (-(-B // 128))))
    for k, n in DENSITY_SHAPES:
        M_np = (rng.random((k, n)) < 0.08).astype(np.float32)
        A_np = (rng.random((n, n)) < 0.2).astype(np.float32)
        M, A = torch.from_numpy(M_np).to(dev), torch.from_numpy(A_np).to(dev)
        if not np.array_equal(
                ops.pair_edges(M_np, A_np, device=dev),
                kernels.clique_pair_edges_plain(M, A).cpu().numpy()):
            raise AssertionError(f"ops.pair_edges differs at k={k} n={n}")
        recs.append(_record(
            "clique_pair_edges", {"k": k, "n": n},
            lambda: kernels.clique_pair_edges(M, A),
            lambda: kernels.clique_pair_edges_plain(M, A),
            lambda: M @ A @ M.T,
            bound(product_ops(M, A) + product_ops(M @ A, M.T), PEAK_TF32,
                  4.0 * (k * n + n * n + k * k)),
            dev, reps))
    omega, d, R, C = LOOKUP
    table = torch.from_numpy(
        rng.normal(size=(C, omega, d)).astype(np.float32)).to(dev)
    cids = torch.from_numpy(rng.integers(0, C, R).astype(np.int32)).to(dev)
    recs += _lookup_pair("reference", table, cids, dev, reps)
    table = torch.from_numpy(
        rng.normal(size=(BIG_C, omega, d)).astype(np.float32)).to(dev)
    cids = torch.from_numpy(
        rng.integers(0, BIG_C, big_requests).astype(np.int32)).to(dev)
    recs += _lookup_pair("catalog-10k", table, cids, dev, reps)
    return recs


def rows_of(recs: list[dict]) -> list[tuple]:
    """CSV rows (name, us per call of the kernel, derived) of the records."""
    rows = []
    for r in recs:
        sh = r["shape"]
        if r["name"] == "crm_update":
            tag = f"B{sh['B']}_n{sh['n']}"
        elif r["name"] == "clique_pair_edges":
            tag = f"k{sh['k']}_n{sh['n']}"
        else:
            tag = f"{sh['config']}_C{sh['C']}_R{sh['R']}"
        us = lambda k: "not measured" if r[k] is None else f"{r[k] * 1e3:.2f}"
        derived = (f"equal={r['equal']};plain_us={us('plain_ms')};"
                   f"library_us={us('library_ms')};"
                   f"bound_us={r['bound_ms'] * 1e3:.3f}({r['bound_by']})")
        if "copy_units" in r:
            derived += (f";copy_units={r['copy_units']};"
                        f"bytes_per_unit={r['bytes_per_unit']}")
        rows.append((f"kernel/{r['name']}/{tag}",
                     0 if r["ms"] is None else int(round(r["ms"] * 1e3)),
                     derived))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (checks only, no timing)")
    ap.add_argument("--big-requests", type=int, default=BIG_R,
                    help="requests R of the catalog-10k lookup pair")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls per kernel after one warm-up")
    args = ap.parse_args(argv)
    if args.device in (None, "cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    recs = run(args.device, big_requests=args.big_requests, reps=args.reps)
    dev = torch.device(args.device or "cuda")
    common.save_json("torch_kernel_bench", {
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "rows": recs})
    common.emit(rows_of(recs))
    print(json.dumps({"kernel_bench": recs}))
    return recs


if __name__ == "__main__":
    main()
