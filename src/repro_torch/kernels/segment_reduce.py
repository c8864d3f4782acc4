"""Segmented running max / running (max, latest argmax) of the replay scan.

The port of ``repro.kernels.segment_reduce`` (TPU kernels
``seg_running_max`` and ``seg_running_argmax``, Pallas bodies
``_segmax_kernel`` / ``_segargmax_kernel``).  The host-schedule replay
calls them once a step when dt differs across servers: the argmax scan
resolves the Alg.-6 anchor over the clique-sorted events, the max scan
gives each (clique, server) pair its post-batch expiry.

:func:`seg_running_max` and :func:`seg_running_argmax` launch the
hand-written CUDA kernel ``csrc/segment_reduce.cu`` for CUDA tensors and
run the plain versions (the reference's Hillis-Steele rounds) for CPU
tensors.  Both only select values, so they agree bit for bit.

Under a sweep's scenario lanes the values carry a leading lane axis,
``(S, L)``, over one shared ``(L,)`` start vector (the lanes share the
schedule, not the prices): each lane is scanned on its own, as
``jax.vmap`` of the reference's scan gives it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def _scan_rounds(v, starts, idx):
    """The doubling rounds of ``_scan_rounds`` on the last axis: an earlier
    candidate wins only if STRICTLY greater, so ties keep the later
    index."""
    L = v.shape[-1]
    seg = torch.cumsum(starts.to(torch.int64), 0)
    d = 1
    while d < L:
        take = (seg[d:] == seg[:-d]) & (v[..., :-d] > v[..., d:])
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
    lane for (S, L) values."""
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
    if values.dim() not in (1, 2) or starts.dim() != 1 \
            or starts.shape[0] != values.shape[-1]:
        raise ValueError(f"{name} needs (L,) or (S, L) values and (L,) "
                         f"starts, got {tuple(values.shape)} and "
                         f"{tuple(starts.shape)}")
    if not (values.is_contiguous() and starts.is_contiguous()):
        raise ValueError(f"{name} needs contiguous values and starts")
    if values.numel() >= 1 << 31:
        raise ValueError(f"{name}: {values.numel()} positions overflow int32")
    S = int(values.shape[0]) if values.dim() == 2 else 1
    if S > 65535:
        raise ValueError(f"{name}: {S} lanes exceed the grid's y extent")
    return S, int(values.shape[-1])


def seg_running_max(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """values (L,) or (S, L) float64, starts (L,) bool -> running max of
    the values' shape.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``seg_running_max.launches``), one block per lane.
    """
    if values.device.type == "cpu" and starts.device.type == "cpu":
        return seg_running_max_plain(values, starts)
    S, L = _check("seg_running_max", values, starts)
    out = torch.empty_like(values)
    if L == 0 or S == 0:
        return out
    launch = _build.function("segment_reduce", "seg_running_max_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    code = launch(values.data_ptr(), starts.data_ptr(), out.data_ptr(), S, L,
                  _build.stream(values))
    _build.check("segment_reduce", "segment_reduce", code)
    seg_running_max.launches += 1
    return out


def seg_running_argmax(values: torch.Tensor, starts: torch.Tensor):
    """values (L,) or (S, L) float64, starts (L,) bool -> (running max,
    int32 latest index within the lane attaining it), both of the values'
    shape.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``seg_running_argmax.launches``), one block per lane.
    """
    if values.device.type == "cpu" and starts.device.type == "cpu":
        return seg_running_argmax_plain(values, starts)
    S, L = _check("seg_running_argmax", values, starts)
    out_v = torch.empty_like(values)
    out_i = torch.empty(values.shape, dtype=torch.int32, device=values.device)
    if L == 0 or S == 0:
        return out_v, out_i
    launch = _build.function("segment_reduce", "seg_running_argmax_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    code = launch(values.data_ptr(), starts.data_ptr(), out_v.data_ptr(),
                  out_i.data_ptr(), S, L,
                  _build.stream(values))
    _build.check("segment_reduce", "segment_reduce", code)
    seg_running_argmax.launches += 1
    return out_v, out_i


seg_running_max.launches = 0
seg_running_argmax.launches = 0
