"""Segmented running max / running (max, latest argmax) of the replay scan.

The port of ``repro.kernels.segment_reduce`` (TPU kernels
``seg_running_max`` and ``seg_running_argmax``, Pallas bodies
``_segmax_kernel`` / ``_segargmax_kernel``).  The host-schedule replay
needs both once a step when dt differs across servers: the argmax scan
resolves the Alg.-6 anchor over the clique-sorted events, the max scan
gives each (clique, server) pair its post-batch expiry.

:func:`seg_scan_step` is what the replay calls: both scans of one step in
one launch of ``csrc/segment_reduce.cu``, each operand ``t + dt[lane, j]``
formed inside the kernel.  :func:`seg_running_max` and
:func:`seg_running_argmax` run the same device code on given values (the
kernel bench, ``ops.py``).  Every wrapper launches its kernel for CUDA
tensors and runs its plain version (the reference's Hillis-Steele rounds)
for CPU tensors.  The scans only select values, and the kernel's add rounds
as PyTorch's does, so the two agree bit for bit.

Under a sweep's scenario lanes the values carry a leading lane axis,
``(S, L)``, over one shared ``(L,)`` start vector (the lanes share the
schedule, not the prices): each lane is scanned on its own, as
``jax.vmap`` of the reference's scan gives it.  Lanes that each have a
schedule (trace shards, cohorts of schedules) give the standalone scans
``(S, L)`` starts, and :func:`seg_scan_step` ``(G, L)`` event rows with an
``(S,)`` map ``rows`` from each lane to its row.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_MAX_ARGS = [_P, _P, _I, _P, _I, _I, _P]
_ARGMAX_ARGS = [_P, _P, _I, _P, _P, _I, _I, _P]
_STEP_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P]


def _scan_rounds(v, starts, idx):
    """The doubling rounds of ``_scan_rounds`` on the last axis: an earlier
    candidate wins only if STRICTLY greater, so ties keep the later
    index."""
    L = v.shape[-1]
    seg = torch.cumsum(starts.to(torch.int64), -1)
    d = 1
    while d < L:
        take = (seg[..., d:] == seg[..., :-d]) & (v[..., :-d] > v[..., d:])
        v = torch.cat([v[..., :d], torch.where(take, v[..., :-d], v[..., d:])],
                      dim=-1)
        if idx is not None:
            idx = torch.cat([idx[..., :d],
                             torch.where(take, idx[..., :-d], idx[..., d:])],
                            dim=-1)
        d <<= 1
    return v, idx


def seg_running_max_plain(values: torch.Tensor,
                          starts: torch.Tensor) -> torch.Tensor:
    """The twin of ``seg_running_max_jnp``: the inclusive per-segment
    running max of ``values`` (position 0 always starts a segment), per
    lane for (S, L) values, over (L,) starts or a lane's own (S, L)."""
    return _scan_rounds(values, starts, None)[0]


def seg_running_argmax_plain(values: torch.Tensor, starts: torch.Tensor):
    """The twin of ``seg_running_argmax_jnp``: the running max and the
    int32 index (within the lane) of the latest position attaining it in
    its segment."""
    idx = torch.arange(values.shape[-1], dtype=torch.int32,
                       device=values.device).expand(values.shape)
    return _scan_rounds(values, starts, idx)


def _check(name: str, values: torch.Tensor,
           starts: torch.Tensor) -> tuple[int, int]:
    if values.device.type != "cuda" or starts.device != values.device:
        raise ValueError(
            f"{name} runs on one cuda device or the cpu, got "
            f"{values.device} and {starts.device}")
    if values.dtype != torch.float64 or starts.dtype != torch.bool:
        raise ValueError(f"{name} needs float64 values and bool starts, got "
                         f"{values.dtype} and {starts.dtype}")
    if values.dim() not in (1, 2) or starts.shape not in (
            values.shape[-1:], values.shape):
        raise ValueError(f"{name} needs (L,) or (S, L) values and (L,) "
                         f"starts or starts of the values' shape, got "
                         f"{tuple(values.shape)} and {tuple(starts.shape)}")
    if not (values.is_contiguous() and starts.is_contiguous()):
        raise ValueError(f"{name} needs contiguous values and starts")
    if values.numel() >= 1 << 31:
        raise ValueError(f"{name}: {values.numel()} positions overflow int32")
    S = int(values.shape[0]) if values.dim() == 2 else 1
    if S > 65535:
        raise ValueError(f"{name}: {S} lanes exceed the grid's y extent")
    return S, int(values.shape[-1])


def seg_running_max(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """values (L,) or (S, L) float64, starts (L,) bool or bool of the
    values' shape (a start mask a lane) -> running max of the values'
    shape.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``seg_running_max.launches``), one CTA per lane.
    """
    if values.device.type == "cpu" and starts.device.type == "cpu":
        return seg_running_max_plain(values, starts)
    S, L = _check("seg_running_max", values, starts)
    out = torch.empty_like(values)
    if L == 0 or S == 0:
        return out
    launch = _build.function("segment_reduce", "seg_running_max_launch",
                             _MAX_ARGS)
    code = launch(values.data_ptr(), starts.data_ptr(), starts.dim() == 2,
                  out.data_ptr(), S, L, _build.stream(values))
    _build.check("segment_reduce", "segment_reduce", code)
    seg_running_max.launches += 1
    return out


def seg_running_argmax(values: torch.Tensor, starts: torch.Tensor):
    """values (L,) or (S, L) float64, starts as :func:`seg_running_max`
    takes them -> (running max, int32 latest index within the lane
    attaining it), both of the values' shape.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``seg_running_argmax.launches``), one CTA per lane.
    """
    if values.device.type == "cpu" and starts.device.type == "cpu":
        return seg_running_argmax_plain(values, starts)
    S, L = _check("seg_running_argmax", values, starts)
    out_v = torch.empty_like(values)
    out_i = torch.empty(values.shape, dtype=torch.int32, device=values.device)
    if L == 0 or S == 0:
        return out_v, out_i
    launch = _build.function("segment_reduce", "seg_running_argmax_launch",
                             _ARGMAX_ARGS)
    code = launch(values.data_ptr(), starts.data_ptr(), starts.dim() == 2,
                  out_v.data_ptr(), out_i.data_ptr(), S, L,
                  _build.stream(values))
    _build.check("segment_reduce", "segment_reduce", code)
    seg_running_argmax.launches += 1
    return out_v, out_i


def seg_scan_step_plain(t_s, j_s, first_cs, cj_t_s, cj_j_s, first_cjs,
                        dt, rows=None):
    """The replay step's two scans as PyTorch ops: the argmax scan of
    ``t_s + dt[:, j_s]`` over ``first_cs`` and the max scan of ``cj_t_s +
    dt[:, cj_j_s]`` over ``first_cjs``.  Returns ``(v, bidx, vmax)``, each
    (S, L), ``bidx`` int64.  With ``rows`` the six event tensors are (G, L)
    rows and lane s scans row ``rows[s]``: the rows are gathered, then
    scanned as the shared form scans one.

    Server ids must lie in [0, m).  Outside it this chain and the kernel
    part ways: here PyTorch's indexing raises for an id >= m and wraps a
    negative one, the kernel prices either as NaN.  The replay checks its
    schedule's ids once on the host (``core/replay.py::run_schedules``)."""
    if rows is not None:
        t_s, j_s, first_cs, cj_t_s, cj_j_s, first_cjs = (
            a[rows] for a in (t_s, j_s, first_cs, cj_t_s, cj_j_s, first_cjs))
        v, bidx = seg_running_argmax_plain(t_s + dt.gather(1, j_s), first_cs)
        vmax = seg_running_max_plain(cj_t_s + dt.gather(1, cj_j_s),
                                     first_cjs)
        return v, bidx.to(torch.int64), vmax
    v, bidx = seg_running_argmax_plain(t_s + dt[:, j_s], first_cs)
    vmax = seg_running_max_plain(cj_t_s + dt[:, cj_j_s], first_cjs)
    return v, bidx.to(torch.int64), vmax


def _check_step(args, rows) -> tuple[int, int, int]:
    t_s, j_s, first_cs, cj_t_s, cj_j_s, first_cjs, dt = args
    every = args if rows is None else (*args, rows)
    if dt.device.type != "cuda" or any(a.device != dt.device for a in every):
        raise ValueError("seg_scan_step runs on one cuda device or the cpu, "
                         f"got {sorted({str(a.device) for a in every})}")
    shape = tuple(t_s.shape)
    if len(shape) != (1 if rows is None else 2):
        raise ValueError("seg_scan_step needs (L,) events, or (G, L) events "
                         f"with rows, got {shape} and rows "
                         f"{None if rows is None else tuple(rows.shape)}")
    L = shape[-1]
    for name, a, dtype in (("t_s", t_s, torch.float64),
                           ("j_s", j_s, torch.int64),
                           ("first_cs", first_cs, torch.bool),
                           ("cj_t_s", cj_t_s, torch.float64),
                           ("cj_j_s", cj_j_s, torch.int64),
                           ("first_cjs", first_cjs, torch.bool)):
        if a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"seg_scan_step needs a contiguous {shape} "
                             f"{dtype} {name}, got {tuple(a.shape)} "
                             f"{a.dtype}")
    if dt.dtype != torch.float64 or dt.dim() != 2 or not dt.is_contiguous():
        raise ValueError(f"seg_scan_step needs a contiguous (S, m) float64 "
                         f"dt, got {tuple(dt.shape)} {dt.dtype}")
    S, m = (int(d) for d in dt.shape)
    if rows is not None and (rows.dtype != torch.int64
                             or tuple(rows.shape) != (S,)
                             or not rows.is_contiguous()):
        raise ValueError(f"seg_scan_step needs contiguous ({S},) int64 rows, "
                         f"got {tuple(rows.shape)} {rows.dtype}")
    if t_s.numel() >= 1 << 31 or m >= 1 << 31 or S > 65535:
        raise ValueError(f"seg_scan_step: S {S}, events {shape}, m {m} out "
                         "of range")
    return S, L, m


def seg_scan_step(t_s, j_s, first_cs, cj_t_s, cj_j_s, first_cjs, dt,
                  rows=None):
    """Both scans of one replay step under per-server dt.

    ``t_s`` / ``cj_t_s`` float64 event times, ``j_s`` / ``cj_j_s`` int64
    server ids in [0, m), ``first_cs`` / ``first_cjs`` bool segment starts:
    (L,) tensors shared by the lanes, or, with ``rows`` (S,) int64, (G, L)
    rows of which lane s takes row ``rows[s]`` (each in [0, G): the caller
    checks that on the host, as a check here would cost a sync); ``dt``
    (S, m) float64.  Returns ``(v, bidx, vmax)`` as
    :func:`seg_scan_step_plain` does.

    CPU tensors take the plain version; CUDA tensors launch one kernel
    (counted in ``seg_scan_step.launches``), a CTA per (scan, lane).  The
    server ids are not checked on the card, which would cost a sync: an id
    outside [0, m) gives a NaN operand (see :func:`seg_scan_step_plain`).
    """
    args = (t_s, j_s, first_cs, cj_t_s, cj_j_s, first_cjs, dt)
    if all(a.device.type == "cpu" for a in args) and (
            rows is None or rows.device.type == "cpu"):
        return seg_scan_step_plain(*args, rows)
    S, L, m = _check_step(args, rows)
    out = torch.empty((3, S, L), dtype=torch.float64, device=dt.device)
    v, bidx, vmax = out[0], out[1].view(torch.int64), out[2]
    if L == 0 or S == 0:
        return v, bidx, vmax
    launch = _build.function("segment_reduce", "seg_scan_step_launch",
                             _STEP_ARGS)
    code = launch(*(a.data_ptr() for a in args[:6]),
                  None if rows is None else rows.data_ptr(),
                  dt.data_ptr(), m, v.data_ptr(), bidx.data_ptr(),
                  vmax.data_ptr(), S, L, _build.stream(dt))
    _build.check("segment_reduce", "segment_reduce", code)
    seg_scan_step.launches += 1
    return v, bidx, vmax


seg_running_max.launches = 0
seg_running_argmax.launches = 0
seg_scan_step.launches = 0
