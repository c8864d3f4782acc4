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

:func:`worst_cases` builds the inputs that the sparse designs of
``crm_update`` and ``clique_pair_edges`` could get wrong (dense and empty
rows, strided views, ragged row counts, memberships with slots in several
groups, S 1 and h 1); ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold both kernels against their plain versions on them.
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


def _incidence(rng, rows: int, h: int, ones: int = 5) -> np.ndarray:
    """A (rows, h + 1) buffer with up to ``ones`` ones a row, the last
    column the dump slot, as the device clique generation builds it."""
    H = np.zeros((rows, h + 1), np.float32)
    cols = rng.integers(0, h + 1, size=(rows, ones))
    H[np.repeat(np.arange(rows), ones), cols.reshape(-1)] = 1.0
    return H


def _binary(rng, h: int, p: float) -> np.ndarray:
    A = np.triu(rng.random((h, h)) < p, 1)
    return (A | A.T).astype(np.float32)


def worst_cases(device, seed: int = 0) -> list[tuple[str, str, tuple]]:
    """(kernel, label, arguments) of ``crm_update`` and ``clique_pair_edges``
    on inputs their sparse designs could get wrong, on ``device``."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    cases = []

    def crm(label, H, strided=False):
        # a strided case passes the leading h columns of the wider buffer
        t = torch.from_numpy(H).to(dev)
        cases.append(("crm_update", label, (t[:, :-1] if strided else t,)))

    def rand(shape, p):
        return (rng.random(shape) < p).astype(np.float32)

    crm("H density 0.5 (3001 x 1000)", rand((3001, 1000), 0.5))
    crm("H density 0.5 (1001 x 32)", rand((1001, 32), 0.5))
    crm("H all ones (777 x 6)", np.ones((777, 6), np.float32))
    H = _incidence(rng, 3001, 1000)
    H[17] = 1.0
    crm("H one row of ones, strided (3001 x 1000 of 1001)", H, True)
    crm("H all zero (1001 x 1000)", np.zeros((1001, 1000), np.float32))
    crm("H ~64 ones a row (2000 x 600)", rand((2000, 600), 64 / 600))
    for h, rows in ((1, 4097), (6, 25_001), (32, 22_977), (1000, 3001),
                    (1024, 22_913)):
        crm(f"H strided (wcap {rows}, h {h} of {h + 1})",
            _incidence(rng, rows, h), True)
    for h, rows in ((6, 1), (6, 513), (100, 1), (100, 9)):
        crm(f"H ragged rows ({rows} x {h})", _incidence(rng, rows, h)[:, :h])

    def cpe(label, M, A):
        cases.append(("clique_pair_edges", label,
                      (torch.from_numpy(M).to(dev),
                       torch.from_numpy(A).to(dev))))

    cpe("M density 0.3 (S 300, h 1000)", rand((300, 1000), 0.3),
        _binary(rng, 1000, 0.2))
    M = np.zeros((700, 1000), np.float32)
    grp = rng.integers(-1, 350, size=1000)
    M[grp[grp >= 0], np.arange(1000)[grp >= 0]] = 1.0
    cpe("M with empty rows (S 700, h 1000)", M, _binary(rng, 1000, 0.2))
    M = rand((50, 1024), 0.02)
    M[3] = 1.0
    cpe("M a row of ones (S 50, h 1024)", M, _binary(rng, 1024, 0.5))
    cpe("M all zero (S 64, h 32)", np.zeros((64, 32), np.float32),
        _binary(rng, 32, 0.5))
    cpe("S 1 (h 1000, M density 0.3)", rand((1, 1000), 0.3),
        _binary(rng, 1000, 0.2))
    cpe("h 1 (S 5)", np.array([[1], [0], [1], [1], [0]], np.float32),
        np.ones((1, 1), np.float32))
    cpe("S 1, h 1", np.ones((1, 1), np.float32), np.ones((1, 1), np.float32))
    return cases


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
