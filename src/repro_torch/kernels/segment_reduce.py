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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def _scan_rounds(v, starts, idx):
    """The doubling rounds of ``_scan_rounds``: an earlier candidate wins
    only if STRICTLY greater, so ties keep the later index."""
    L = v.shape[0]
    seg = torch.cumsum(starts.to(torch.int64), 0)
    d = 1
    while d < L:
        take = (seg[d:] == seg[:-d]) & (v[:-d] > v[d:])
        v = torch.cat([v[:d], torch.where(take, v[:-d], v[d:])])
        if idx is not None:
            idx = torch.cat([idx[:d], torch.where(take, idx[:-d], idx[d:])])
        d <<= 1
    return v, idx


def seg_running_max_plain(values: torch.Tensor,
                          starts: torch.Tensor) -> torch.Tensor:
    """The twin of ``seg_running_max_jnp``: the inclusive per-segment
    running max of ``values`` (position 0 always starts a segment)."""
    return _scan_rounds(values, starts, None)[0]


def seg_running_argmax_plain(values: torch.Tensor, starts: torch.Tensor):
    """The twin of ``seg_running_argmax_jnp``: the running max and the
    int32 index of the latest position attaining it in its segment."""
    idx = torch.arange(values.shape[0], dtype=torch.int32,
                       device=values.device)
    return _scan_rounds(values, starts, idx)


def _check(name: str, values: torch.Tensor, starts: torch.Tensor) -> int:
    if values.device.type != "cuda" or starts.device != values.device:
        raise ValueError(
            f"{name} runs on one cuda device or the cpu, got "
            f"{values.device} and {starts.device}")
    if values.dtype != torch.float64 or starts.dtype != torch.bool:
        raise ValueError(f"{name} needs float64 values and bool starts, got "
                         f"{values.dtype} and {starts.dtype}")
    if values.dim() != 1 or starts.shape != values.shape:
        raise ValueError(f"{name} needs 1-D values and starts of one length, "
                         f"got {tuple(values.shape)} and {tuple(starts.shape)}")
    if not (values.is_contiguous() and starts.is_contiguous()):
        raise ValueError(f"{name} needs contiguous values and starts")
    if values.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: {values.shape[0]} positions overflow int32")
    return int(values.shape[0])


def seg_running_max(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """values (L,) float64, starts (L,) bool -> (L,) running max.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``seg_running_max.launches``).
    """
    if values.device.type == "cpu" and starts.device.type == "cpu":
        return seg_running_max_plain(values, starts)
    L = _check("seg_running_max", values, starts)
    out = torch.empty_like(values)
    if L == 0:
        return out
    launch = _build.function("segment_reduce", "seg_running_max_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p])
    code = launch(values.data_ptr(), starts.data_ptr(), out.data_ptr(), L,
                  torch.cuda.current_stream(values.device).cuda_stream)
    _build.check("segment_reduce", "segment_reduce", code)
    seg_running_max.launches += 1
    return out


def seg_running_argmax(values: torch.Tensor, starts: torch.Tensor):
    """values (L,) float64, starts (L,) bool -> ((L,) running max, (L,)
    int32 latest index attaining it).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``seg_running_argmax.launches``).
    """
    if values.device.type == "cpu" and starts.device.type == "cpu":
        return seg_running_argmax_plain(values, starts)
    L = _check("seg_running_argmax", values, starts)
    out_v = torch.empty_like(values)
    out_i = torch.empty(L, dtype=torch.int32, device=values.device)
    if L == 0:
        return out_v, out_i
    launch = _build.function("segment_reduce", "seg_running_argmax_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    code = launch(values.data_ptr(), starts.data_ptr(), out_v.data_ptr(),
                  out_i.data_ptr(), L,
                  torch.cuda.current_stream(values.device).cuda_stream)
    _build.check("segment_reduce", "segment_reduce", code)
    seg_running_argmax.launches += 1
    return out_v, out_i


seg_running_max.launches = 0
seg_running_argmax.launches = 0
