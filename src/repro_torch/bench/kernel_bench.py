"""Kernel benchmark of the port: every row of the reference's
``benchmarks/kernel_bench.py``, on the card.

    python -m repro_torch.bench.kernel_bench [--device cuda] [--big-requests 65536]
                                             [--big-slots 20000]

Rows, at the reference's shapes and inputs (numpy seed 0, drawn in the
reference's order):

* ``crm_update`` at B x n = 200 x 60, 2000 x 600 and 8000 x 1024;
* ``clique_pair_edges`` at k x n = 60 x 60 and 200 x 512;
* ``packed_lookup`` against ``unpacked_lookup`` at omega 5, d 256, R 64,
  C 128, float32: the paper's packed transfer in memory-system form, one
  copy per clique (R copy units) against one per item (R omega);

and one lookup pair where bytes matter: C 10,000 cliques (catalog-10k's
n), omega 5, d 256, float32, R 65,536 (a 51 MB table, a 335 MB output);

and the replay step's scans at (S, L) = (1, 8192), (2, 8192), (64, 8192)
and (1, 100,000), starts random at 1% and 50%, m 600 servers:
``seg_scan_step`` on the step's inputs and the standalone
``seg_running_argmax`` / ``seg_running_max`` on its two operands, each
with ``device_ms``, the plain version's time, the bound and
``torch.cummax(values, dim=-1)`` as ``library_ms``: an unsegmented
yardstick that does less work and that the port never calls.

and ``merge_density`` (:func:`merge_inputs`: sizes 1-4, exact integer
pair edges with densities on both sides of gamma, omega 5, gamma 0.85) at
S 64 (k 32), S 2048 (k 229, the captured ``catalog-10k`` merge's act
count, and k = S) and S 20,000 (k 10,000: ``catalog-10k``'s full merge,
S = 2n), each unmasked (``n_act=None``, the TPU kernel's function) and
masked (``n_act=k``), with ``device_ms``, the plain version's time and
the bound by :func:`merge_bound`, beside ``output_fill_device_ms`` (a
fill of D's bytes: the write floor).

Each row holds the kernel against its plain version bit for bit (the two
lookups also against each other: the same bytes, packed and unpacked)
and reports, on the card, the kernel's time, the plain version's, one
PyTorch call's (``H.T @ H``, ``M @ A @ M.T``, ``index_select``; TF32 off;
none for ``merge_density``) and the bound, all in ms by CUDA events after
a warm-up.  The bound is
the larger of the bytes the inputs need (for a lookup: the ids, each
table row they touch read once, the output written once) at 3.35 TB/s
and the products' multiply-adds at these inputs at the TF32 peak.  With
``--device cpu`` the wrappers run their plain versions and only the
checks run: no time is taken on the CPU (cut ``--big-requests`` and
``--big-slots`` there).  The lookup rows also give the
path the copy engine took, ``device_ms`` and ``library_device_ms`` (the
kernel's and ``index_select``'s time on the card alone, from the replay
of a CUDA graph of back-to-back calls: at R 64 a call is shorter than its
wrapper, and ``ms`` reads the host's enqueue), and ``output_memset_ms``,
a memset of the output's bytes: the write floor every gather of these rows
shares.

:func:`lookup_cases` builds an input for every path of the lookups' copy
engine but ``stream`` (4- to 16-byte rows, 1 KB rows of a 1 MB table and
5 KB rows of a 15 MB one, 5 KB + 4 byte rows, a table and ids at an
unaligned offset) at R 1, 3, 64 and 65,537 in int32, float32 and
float16; :func:`check_lookup_case` holds both lookups on one against
their plain versions.

:func:`lane_cases` builds laned inputs of the three CGM kernels (1, 2,
17 and 3 lanes, each lane with its own hot count, omega, gamma and act
count), :func:`mid_crm_cases` inputs of ``crm_update``'s mid path (32 < h
<= 64: 1, 3 and 17 lanes, row strides h and h + 1, rows of ones, empty
and equal rows), :func:`wide_row_cases` a table of ``sliced`` rows of
6 MB less 16 bytes and :func:`stream_lookup_cases` rows of the lookup's
``stream`` path (6 MB + 16 B, 7.9 MB, 23.6 MB and 24 MB at R 1, 2 and 18
in bf16, f32 and int16);
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels on
them.

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
from .common import (
    PEAK_FP32,
    PEAK_FP64,
    PEAK_TF32,
    bound,
    cuda_graph_time,
    cuda_time,
    product_ops,
)
from .. import kernels
from ..kernels import ops

#: reference shapes: CRM (B, n), density (k, n), lookup (omega, d, R, C)
CRM_SHAPES = ((200, 60), (2000, 600), (8000, 1024))
DENSITY_SHAPES = ((60, 60), (200, 512))
LOOKUP = (5, 256, 64, 128)
#: the lookup pair where bytes matter: C cliques, R requests
BIG_C, BIG_R = 10_000, 65_536
#: the lookups' row copy engine: (label, row bytes, the path it takes); the
#: offset cases start the table, or the ids, one element past an aligned
#: address
LOOKUP_ROWS = (
    ("4-byte rows", 4, "narrow"), ("8-byte rows", 8, "narrow"),
    ("12-byte rows", 12, "narrow"), ("16-byte rows", 16, "narrow"),
    ("1 KB rows", 1024, "vector"), ("5 KB rows", 5120, "sliced"),
    ("5 KB + 4 byte rows", 5124, "ragged"),
    ("1 KB rows, table at an unaligned offset", 1024, "ragged"),
    ("4-byte rows, ids at an unaligned offset", 4, "ragged"),
)
LOOKUP_REQUESTS = (1, 3, 64, 65_537)
LOOKUP_DTYPES = (torch.int32, torch.float32, torch.float16)
#: scan rows (lanes S, length L): the replay's step width 8192 at S 1, 2
#: and a wide sweep's 64 lanes, and a lane of 100,000, longer than a tile;
#: starts at each density; dt over hetero-table2's m servers
SCAN_SHAPES = ((1, 8192), (2, 8192), (64, 8192), (1, 100_000))
SCAN_STARTS = (0.01, 0.5)
SCAN_SERVERS = 600
SCAN_YARDSTICK = ("torch.cummax(values, dim=-1): unsegmented, less work, "
                  "never called by the port")
#: merge rows (S, act counts k): netflix-table2's S 64, catalog-10k's
#: S 2048 at the captured merge's 229 act groups and at S (and its full
#: merge, S = 2n = BIG_SLOTS, at k = S / 2)
MERGE_SHAPES = ((64, (32,)), (2048, (229, 2048)))
BIG_SLOTS = 20_000
MERGE_OMEGA, MERGE_GAMMA = 5, 0.85


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


def lookup_case(row: tuple, R: int, dtype, device, seed: int = 0) -> dict:
    """One lookup input of a :data:`LOOKUP_ROWS` entry: a (C, omega, d)
    table of ``row``'s row bytes (omega 5 for the 5 KB rows, else 1; C
    3,000 of them, 15 MB, more than one slice of the sliced design), the
    same bytes as (C, omega d) items, R packed ids and (R, 1) unpacked
    ids, on ``device``."""
    label, row_bytes, route = row
    rng = np.random.default_rng([seed, row_bytes, R])
    dev = torch.device(device)
    elem = torch.empty((), dtype=dtype).element_size()
    omega = 5 if row_bytes == 5120 else 1
    d = row_bytes // elem // omega
    C = 4096 if row_bytes <= 16 else (3000 if row_bytes == 5120 else 1000)
    t_off = 1 if "table at" in label else 0
    i_off = 1 if "ids at" in label else 0
    vals = rng.standard_normal(C * omega * d + t_off) * 100
    flat = torch.from_numpy(vals).to(dtype).to(dev)
    table = flat[t_off:].view(C, omega, d)
    ids = torch.from_numpy(rng.integers(0, C, R + i_off).astype(np.int32))
    cids = ids.to(dev)[i_off:]
    return {"label": f"{label} {dtype} R={R}", "path": route,
            "table": table, "cids": cids,
            "items": table.view(C, omega * d), "iids": cids.view(R, 1)}


def lookup_cases(device, seed: int = 0):
    """Every :data:`LOOKUP_ROWS` entry at every :data:`LOOKUP_REQUESTS`
    and :data:`LOOKUP_DTYPES` (:func:`lookup_case`), one at a time."""
    for row in LOOKUP_ROWS:
        for R in LOOKUP_REQUESTS:
            for dtype in LOOKUP_DTYPES:
                yield lookup_case(row, R, dtype, device, seed)


def check_lookup_case(case: dict) -> list[dict]:
    """Both lookups on one :func:`lookup_case` input on the card: each
    kernel must take the case's path and give its plain version's bits,
    twice in a row.  Returns one report entry a kernel."""
    table, cids = case["table"], case["cids"]
    items, iids = case["items"], case["iids"]
    report = []
    calls = (("packed_lookup", kernels.packed_lookup, kernels.packed_lookup_plain,
              table, cids),
             ("unpacked_lookup", kernels.unpacked_lookup,
              kernels.unpacked_lookup_plain, items, iids))
    for name, kern, plain, src, ids in calls:
        want = plain(src, ids)
        got = kern(src, ids)
        path = kern.last_path
        again = kern(src, ids)
        for p in (path, kern.last_path):
            if p != case["path"]:
                raise AssertionError(f"{name} took the {p} path at "
                                     f"{case['label']}, not {case['path']}")
        torch.cuda.synchronize()
        eq = torch.equal(got, want) and torch.equal(again, want)
        report.append({"kernel": name, "inputs": case["label"],
                       "path": path, "equal": eq})
        if not eq:
            raise AssertionError(f"{name} ({path}) differs from its plain "
                                 f"version at {case['label']}")
    return report


#: laned CGM kernel cases: (lanes, hot capacity h, merge slots): one lane,
#: two, a fig7 super-group's 17, and catalog-10k's hot space at 3 lanes
LANE_SHAPES = ((1, 64, 128), (2, 64, 128), (17, 64, 128), (3, 1024, 2048))
#: the window rows of a laned ``crm_update`` case
LANE_ROWS = 4097
#: a wide row of the ``sliced`` path: a 16-byte unit below one 6 MB slice
#: (rows of a slice or more take ``stream``), with the ids (a repeat)
WIDE_ROWS = (("rows of 6 MB less 16 bytes", (6 << 20) - 16, 5, (4, 0, 4)),)
#: the ``stream`` lookup path: row bytes (a 16-byte unit past one 6 MB
#: slice, granite-moe-3b-a800m's 7.9 MB clique row, the expert cache's
#: 23.6 MB clique row of omega 5 experts of 3 x 1536 x 512, 24 MB),
#: requests and dtypes, from a table of STREAM_C rows (R 18 repeats ids)
STREAM_ROWS = (("6 MB + 16 B", (6 << 20) + 16),
               ("7.9 MB", 5 * 1536 * 512 * 2),
               ("23.6 MB", 5 * 3 * 1536 * 512 * 2), ("24 MB", 24 << 20))
STREAM_REQUESTS = (1, 2, 18)
STREAM_DTYPES = (torch.bfloat16, torch.float32, torch.int16)
STREAM_C = 5
#: crm_update's ``mid`` path (32 < h <= 64): hot widths, lanes and row
#: strides (h, or h + 1 as the device CGM's buffer) at MID_ROWS rows: more
#: than one row for each of the 8,448 warps of one lane's wide grid (so
#: every lane count takes the path), not a multiple of a block's 256
MID_HS = (33, 48, 60, 63, 64)
MID_LANES = (1, 3, 17)
MID_ROWS = 17_153


def lane_cases(device, seed: int = 0) -> list[tuple[str, str, tuple]]:
    """(kernel, label, arguments) of the laned ``crm_update``,
    ``clique_pair_edges`` and ``merge_density`` at :data:`LANE_SHAPES` on
    ``device``: each lane with its own count of hot slots (the rest of its
    columns empty, as a lane with a smaller top_frac has them), its own
    groups, omega, gamma and act count (0, 1, all, and between), H a
    strided view of a (h + 1)-wide buffer.  ``merge_density``'s arguments
    are (X, sizes, omega, gamma32, n_act, act_max)."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    omegas, gammas = (2, 3, 5, 7, 10), (0.6, 0.85, 0.9, 1.0, 0.0)
    cases = []
    for L, h, Sp in LANE_SHAPES:
        hot = [h] + [int(rng.integers(1, h + 1)) for _ in range(L - 1)]
        H = np.zeros((L, LANE_ROWS, h + 1), np.float32)
        M = np.zeros((L, Sp, h), np.float32)
        A = np.zeros((L, h, h), np.float32)
        for lane, k in enumerate(hot):
            inc = _incidence(rng, LANE_ROWS, k)
            H[lane, :, :k] = inc[:, :k]
            groups = int(rng.integers(1, min(k, Sp) + 1))
            grp = rng.integers(0, groups, size=k)
            M[lane, grp, np.arange(k)] = 1.0
            A[lane, :k, :k] = _binary(rng, k, 0.5)
        Ht = torch.from_numpy(H).to(dev)
        label = f"L {L}, h {h}, hot {min(hot)}-{max(hot)}"
        cases.append(("crm_update", f"{label}, rows {LANE_ROWS}, strided",
                      (Ht[:, :, :h],)))
        Mt, At = torch.from_numpy(M).to(dev), torch.from_numpy(A).to(dev)
        cases.append(("clique_pair_edges", f"{label}, S {Sp}", (Mt, At)))
        X = kernels.clique_pair_edges_plain(Mt, At)
        sizes = M.sum(2).astype(np.int32)
        om = torch.tensor([omegas[i % 5] for i in range(L)],
                          dtype=torch.int32, device=dev)
        gm = torch.tensor([np.float32(gammas[i % 5]) for i in range(L)],
                          dtype=torch.float32, device=dev)
        acts = [[0, 1, Sp, Sp // 3, 7][i % 5] for i in range(L)]
        if L == 1:
            acts = [int((sizes[0] > 0).sum())]
        st = torch.from_numpy(sizes).to(dev)
        cases.append(("merge_density", f"{label}, S {Sp}, unmasked",
                      (X, st, om, gm, None, None)))
        cases.append(("merge_density", f"{label}, S {Sp}, n_act {acts}",
                      (X, st, om, gm, torch.tensor(acts, device=dev),
                       max(acts))))
    return cases


def wide_row_cases(device, seed: int = 0):
    """(label, table, ids) of :data:`WIDE_ROWS` on ``device``: float16
    tables of that many rows (16-byte-multiple rows below one slice, more
    than one slice of table: every path ``sliced``)."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    for label, row_bytes, C, ids in WIDE_ROWS:
        g = torch.Generator(device=dev)
        g.manual_seed(int(rng.integers(1 << 30)))
        table = torch.randn((C, row_bytes // 2), generator=g, device=dev,
                            dtype=torch.float32).to(torch.float16)
        yield label, table.view(C, 1, row_bytes // 2), torch.tensor(
            ids, dtype=torch.int32, device=dev)


def stream_lookup_case(row: tuple, R: int, dtype, device,
                       seed: int = 0) -> tuple:
    """(label, table, ids) of one :data:`STREAM_ROWS` entry: a
    (STREAM_C, 1, d) table of ``dtype`` with rows of that many bytes,
    seeded on ``device``, and R ids, unsorted, repeated at R 18."""
    label, row_bytes = row
    dev = torch.device(device)
    elem = torch.empty((), dtype=dtype).element_size()
    d = row_bytes // elem
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.default_rng([seed, row_bytes, R]).integers(
        1 << 30)))
    if dtype.is_floating_point:
        table = torch.randn((STREAM_C, 1, d), generator=g, device=dev,
                            dtype=torch.float32).to(dtype)
    else:
        table = torch.randint(-(1 << 15), 1 << 15, (STREAM_C, 1, d),
                              generator=g, device=dev, dtype=dtype)
    ids = {1: [STREAM_C - 2], 2: [STREAM_C - 1, 0]}.get(R)
    if ids is None:
        ids = np.random.default_rng([seed, R]).integers(0, STREAM_C, R)
    return (f"rows of {label}, {dtype}, R={R}", table,
            torch.tensor(ids, dtype=torch.int32, device=dev))


def stream_lookup_cases(device, seed: int = 0):
    """Every :data:`STREAM_ROWS` entry at every :data:`STREAM_REQUESTS`
    and :data:`STREAM_DTYPES` (:func:`stream_lookup_case`), one at a
    time."""
    for row in STREAM_ROWS:
        for R in STREAM_REQUESTS:
            for dtype in STREAM_DTYPES:
                yield stream_lookup_case(row, R, dtype, device, seed)


def mid_crm_case(lanes: int, h: int, extra: int, rows: int, device,
                 seed: int = 0) -> tuple:
    """(label, H) of ``crm_update``'s mid path: H the leading h columns of
    a (lanes, rows, h + extra) buffer (2-D at one lane), up to 5 ones a
    row, and in every lane rows of all ones, a run of empty rows and a run
    of 70 equal rows (a popular bundle: lanes of one warp with one mask)."""
    rng = np.random.default_rng([seed, lanes, h, extra, rows])
    buf = np.zeros((lanes, rows, h + extra), np.float32)
    for lane in range(lanes):
        buf[lane, :, :h] = _incidence(rng, rows, h)[:, :h]
        buf[lane, min(7, rows - 1), :h] = 1.0
        buf[lane, rows - 1, :h] = 1.0
        buf[lane, 100:164] = 0.0
        buf[lane, 300:370, :h] = 0.0
        buf[lane, 300:370, rng.choice(h, 4, replace=False)] = 1.0
    t = torch.from_numpy(buf).to(torch.device(device))[:, :, :h]
    return (f"L {lanes}, h {h} of {h + extra}, rows {rows}",
            t[0] if lanes == 1 else t)


def mid_crm_cases(device, seed: int = 0):
    """:func:`mid_crm_case` at every :data:`MID_HS` x :data:`MID_LANES` x
    row stride h and h + 1, at MID_ROWS rows."""
    for h in MID_HS:
        for lanes in MID_LANES:
            for extra in (0, 1):
                yield mid_crm_case(lanes, h, extra, MID_ROWS, device, seed)


def scan_step_inputs(rng, S: int, L: int, starts, m: int, device) -> tuple:
    """``seg_scan_step``'s arguments on ``device``: for each of its two
    scans, (L,) times, half from a few multiples of 0.5 (ties everywhere)
    and half continuous (sums that round), with 10% -inf, int64 server ids
    in [0, m) and start flags (``"all"``, ``"first"`` only, or random at
    the density ``starts``); then a (S, m) dt, half multiples of 0.25 and
    half continuous."""
    dev = torch.device(device)

    def half_continuous(a, scale):
        cont = rng.random(a.shape) < 0.5
        a[cont] = rng.random(int(cont.sum())) * scale
        return a

    def problem():
        t = half_continuous(rng.integers(0, 8, size=L) * 0.5, 10.0)
        t[rng.random(L) < 0.1] = -np.inf
        j = rng.integers(0, m, size=L)
        if starts == "all":
            s = np.ones(L, bool)
        elif starts == "first":
            s = np.zeros(L, bool)
            s[0] = True
        else:
            s = rng.random(L) < float(starts)
        return [torch.from_numpy(a).to(dev) for a in (t, j, s)]

    first, second = problem(), problem()
    dt = half_continuous(rng.integers(1, 4, size=(S, m)) * 0.25, 2.0)
    dt = torch.from_numpy(dt).to(dev)
    return (*first, *second, dt)


def scan_step_rows_inputs(rng, G: int, S: int, L: int, starts, m: int,
                          device) -> tuple:
    """``seg_scan_step``'s per-lane-rows arguments: G event rows of each
    scan, each drawn as :func:`scan_step_inputs` draws the shared form's,
    a (S, m) dt and the (S,) int64 map of lane s to row s % G."""
    per = [scan_step_inputs(rng, S, L, starts, m, device) for _ in range(G)]
    ev = tuple(torch.stack([p[k] for p in per]) for k in range(6))
    rows = torch.arange(S, dtype=torch.int64, device=device) % G
    return (*ev, per[0][6], rows)


def scan_bound(name: str, S: int, L: int, m: int = 0, G: int = 1,
               lane_starts: bool = False) -> dict:
    """The bound of a scan at (S, L): each input read once, each output
    written once (the step: its G rows of event inputs, shared when G is
    1, the lane map, dt, three outputs; its adds and compares at the fp64
    peak; a standalone scan: its values, its (L,) starts or (S, L) with
    ``lane_starts``, its outputs)."""
    if name == "seg_scan_step":
        return bound(4.0 * S * L, PEAK_FP64,
                     2.0 * G * L * (8 + 8 + 1) + 8.0 * S * m + 24.0 * S * L
                     + (8.0 * S if G > 1 else 0.0))
    out = 12.0 if name == "seg_running_argmax" else 8.0
    return bound(float(S * L), PEAK_FP64,
                 S * L * (8.0 + out) + (S * L if lane_starts else L))


def scan_records(args: tuple, shape: dict, dev, reps: int) -> list[dict]:
    """``seg_scan_step`` on ``args`` and the standalone scans on its two
    operands (formed by PyTorch ops), each held bitwise against its plain
    version and timed (:func:`_record`, ``device_ms`` from 100 captured
    calls)."""
    t_a, j_a, s_a, t_m, j_m, s_m, dt = args
    S, m = (int(d) for d in dt.shape)
    L = int(t_a.shape[0])
    va = t_a + dt[:, j_a]
    vm = t_m + dt[:, j_m]
    both = torch.stack([va, vm])
    calls = 100
    extra = {"library_call": SCAN_YARDSTICK}
    recs = [_record("seg_scan_step", shape,
                    lambda: kernels.seg_scan_step(*args),
                    lambda: kernels.seg_scan_step_plain(*args),
                    lambda: torch.cummax(both, dim=-1),
                    scan_bound("seg_scan_step", S, L, m), dev, reps,
                    graph_calls=calls, **extra)]
    for name, v, s in (("seg_running_argmax", va, s_a),
                       ("seg_running_max", vm, s_m)):
        kern, plain = kernels.KERNELS[name], getattr(kernels, name + "_plain")
        recs.append(_record(name, shape, lambda k=kern, v=v, s=s: k(v, s),
                            lambda p=plain, v=v, s=s: p(v, s),
                            lambda v=v: torch.cummax(v, dim=-1),
                            scan_bound(name, S, L), dev, reps,
                            graph_calls=calls, **extra))
    return recs


def _scan_rows(dev, reps: int) -> list[dict]:
    recs = []
    for S, L in SCAN_SHAPES:
        for p in SCAN_STARTS:
            rng = np.random.default_rng([S, L, int(p * 100)])
            args = scan_step_inputs(rng, S, L, p, SCAN_SERVERS, dev)
            recs += scan_records(args, {"S": S, "L": L, "starts": p,
                                        "m": SCAN_SERVERS}, dev, reps)
    return recs


def merge_inputs(S: int, device, seed: int = 0) -> tuple:
    """``merge_density``'s (X, sizes) at S slots, drawn on ``device`` from
    a seeded ``torch.Generator``: sizes 1-4 (omega 5 pairs 1 with 4 and 2
    with 3); X symmetric exact integer pair edges, ``round(s_i s_j u)``
    between two groups and ``round(s_i (s_i - 1) u)`` within one, u
    uniform in [0.5, 1): densities on both sides of gamma 0.85."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sizes = torch.randint(1, 5, (S,), generator=g, device=dev,
                          dtype=torch.int32)
    sf = sizes.to(torch.float32)
    u = torch.rand((S, S), generator=g, device=dev).mul_(0.5).add_(0.5)
    X = torch.triu(u.mul_(sf[:, None]).mul_(sf[None, :]).round_(), 1)
    del u
    X += X.T.clone()
    ud = torch.rand(S, generator=g, device=dev).mul_(0.5).add_(0.5)
    X.diagonal().copy_((sf * (sf - 1.0) * ud).round_())
    return X, sizes


def merge_bound(sizes: torch.Tensor, omega: int, n_act=None) -> dict:
    """The bound of ``merge_density`` at these sizes: D written once, the
    sizes and X's diagonal read once, and X read only at the entries
    whose result depends on it (the size gate passes off the diagonal,
    inside the k x k act block when masked); their two adds and divide
    at the fp32 peak.  ``bytes_all_x``/``bound_all_x_ms`` keep the count
    of all of X read (the count of the kernel's first design)."""
    S = int(sizes.shape[0])
    k = S if n_act is None else int(n_act)
    s = sizes[:k].to(torch.int64)
    if k and int(s.min()) < 0:
        raise ValueError("group sizes are >= 0")
    cnt = torch.bincount(s[s <= omega], minlength=omega + 1).double().cpu()
    passing = float((cnt * cnt.flip(0)).sum())
    if omega % 2 == 0:
        passing -= float(cnt[omega // 2])          # i == j
    rec = bound(4.0 * passing, PEAK_FP32,
                4.0 * S * S + 8.0 * S + 4.0 * passing)
    all_x = 4.0 * (2 * S * S + S)
    return {**rec, "x_entries_read": passing, "bytes_all_x": all_x,
            "bound_all_x_ms": all_x / common.PEAK_BYTES * 1e3}


def merge_records(X, sizes, n_acts, shape: dict, dev, reps: int) -> list:
    """``merge_density`` on (X, sizes) unmasked and at each ``n_acts``, each
    held bitwise against its plain version and timed (:func:`_record`);
    on the card also the fill of D's bytes."""
    S = int(X.shape[0])
    calls = 100 if S * S * 4 < 64e6 else 10
    recs = []
    for k in (None, *n_acts):
        args = (X, sizes, MERGE_OMEGA, float(np.float32(MERGE_GAMMA)), k)
        rec = _record("merge_density", {**shape, "S": S, "n_act": k},
                      lambda a=args: kernels.merge_density(*a),
                      lambda a=args: kernels.merge_density_plain(*a), None,
                      merge_bound(sizes, MERGE_OMEGA, k), dev, reps,
                      graph_calls=calls)
        if dev.type == "cuda":
            D = torch.empty((S, S), dtype=torch.float32, device=dev)
            rec["output_fill_device_ms"] = cuda_graph_time(
                lambda: D.fill_(-2.0), calls)
        recs.append(rec)
    return recs


def _merge_rows(dev, reps: int, big_slots: int) -> list[dict]:
    recs = []
    for S, ks in (*MERGE_SHAPES, (big_slots, (big_slots // 2,))):
        X, sizes = merge_inputs(S, dev, seed=S)
        recs += merge_records(X, sizes, ks, {"omega": MERGE_OMEGA,
                                             "gamma": MERGE_GAMMA}, dev, reps)
        del X, sizes
    return recs


def device_times(kern, lib, calls: int) -> dict:
    """``device_ms`` and ``library_device_ms``: the kernel's and the
    library call's time on the card alone (:func:`common.cuda_graph_time`
    over ``calls`` captured calls); None where there is no library
    call."""
    return {"device_ms": cuda_graph_time(kern, calls),
            "library_device_ms": cuda_graph_time(lib, calls) if lib else None}


def _same(got, want) -> bool:
    """Bitwise equality of two tensors or two tuples of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))


def _record(name, shape, kern, plain, lib, bnd, dev, reps, *,
            graph_calls: int = 0, **extra) -> dict:
    """Hold ``kern()`` bitwise against ``plain()`` (tensors or tuples of
    them); on the card, time the kernel, the plain version and the library
    call (and, given ``graph_calls``, the kernel's and the library call's
    device time)."""
    got, want = kern(), plain()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not _same(got, want):
        pairs = zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want)))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in pairs)
        raise AssertionError(f"{name} {shape} differs from its plain version: "
                             f"max abs err {err}")
    rec = {"name": name, "shape": shape, "equal": True, "max_abs_err": 0.0,
           **bnd, **extra}
    if dev.type == "cuda":
        rec.update(ms=cuda_time(kern, reps), plain_ms=cuda_time(plain, reps),
                   library_ms=cuda_time(lib, reps) if lib else None)
        if graph_calls:
            rec.update(device_times(kern, lib, graph_calls))
    else:
        rec.update(ms=None, plain_ms=None, library_ms=None)
        if graph_calls:
            rec.update(device_ms=None, library_device_ms=None)
    return rec


def _lookup_pair(label, table, cids, dev, reps) -> list[dict]:
    """packed_lookup of ``table`` at ``cids`` against unpacked_lookup of
    the same bytes as item rows at the cliques' item ids.  On the card
    each row also gets the path its kernel took, and its and
    ``index_select``'s device time."""
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
    # calls a captured graph holds: enough to pass the replay's own cost,
    # few where one call writes a large output
    calls = 100 if out_bytes < 64e6 else 10
    # the ids are checked once here; the timed calls skip the check (a
    # device -> host read of the ids' range)
    got_u = ops.gather_unpacked(items, iids)
    got_p = ops.gather_packed(table, cids)
    paths = {"packed_lookup": kernels.packed_lookup.last_path,
             "unpacked_lookup": kernels.unpacked_lookup.last_path}
    if not torch.equal(got_u, got_p):
        raise AssertionError(f"unpacked_lookup differs from packed_lookup on "
                             f"the same bytes at {label}")
    # the output's bytes written alone (a memset of the same size): the
    # floor any gather of these rows shares
    floor = ({"output_memset_ms": cuda_time(lambda: got_p.zero_(), reps)}
             if dev.type == "cuda" else {})
    recs = []
    for name, gather, plain, src, ids, lib_ids, units, unit_bytes in (
            ("packed_lookup", ops.gather_packed, kernels.packed_lookup_plain,
             table, cids, cids, R, omega * d * elem),
            ("unpacked_lookup", ops.gather_unpacked,
             kernels.unpacked_lookup_plain, items, iids, iids.reshape(-1),
             R * omega, d * elem)):
        rec = _record(
            name, {**shape, "config": label},
            lambda g=gather, s=src, i=ids: g(s, i, ids_checked=True),
            lambda p=plain, s=src, i=ids: p(s, i),
            lambda s=src, i=lib_ids: s.index_select(0, i),
            bound(0.0, PEAK_FP32,
                  4.0 * units + rows * omega * d * elem + out_bytes),
            dev, reps, graph_calls=calls, copy_units=units,
            bytes_per_unit=unit_bytes, **floor)
        rec["equal_unpacked" if name == "packed_lookup"
            else "equal_packed"] = True
        if dev.type == "cuda":
            rec["path"] = paths[name]
        recs.append(rec)
    return recs


def run(device=None, *, big_requests: int = BIG_R,
        big_slots: int = BIG_SLOTS, reps: int = 20) -> list[dict]:
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
    recs += _scan_rows(dev, reps)
    recs += _merge_rows(dev, reps, big_slots)
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
        elif r["name"] == "merge_density":
            tag = f"S{sh['S']}_k{sh['n_act']}"
        elif "starts" in sh:
            tag = f"S{sh['S']}_L{sh['L']}_starts{sh['starts']}"
        else:
            tag = f"{sh['config']}_C{sh['C']}_R{sh['R']}"
        us = lambda k: "not measured" if r[k] is None else f"{r[k] * 1e3:.2f}"
        derived = (f"equal={r['equal']};plain_us={us('plain_ms')};"
                   f"library_us={us('library_ms')};"
                   f"bound_us={r['bound_ms'] * 1e3:.3f}({r['bound_by']})")
        if "device_ms" in r:
            derived += (f";device_us={us('device_ms')};"
                        f"library_device_us={us('library_device_ms')}")
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
    ap.add_argument("--big-slots", type=int, default=BIG_SLOTS,
                    help="slots S of the largest merge_density row (its "
                    "act count k is S / 2)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls per kernel after one warm-up")
    args = ap.parse_args(argv)
    if args.device in (None, "cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    recs = run(args.device, big_requests=args.big_requests,
               big_slots=args.big_slots, reps=args.reps)
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
