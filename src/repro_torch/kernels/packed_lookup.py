"""Packed and unpacked gathers, and the replay's per-batch item -> clique lookup.

The port of ``repro.kernels.packed_lookup``:

* :func:`packed_lookup` (TPU kernel ``packed_lookup``, Pallas body
  ``_copy_kernel``): ``out[r] = table[ids[r]]`` for whole packed
  ``(omega, d)`` rows, one copy per request;
* :func:`unpacked_lookup` (TPU kernel ``unpacked_lookup``, Pallas body
  ``_copy_reshape_kernel``): the baseline, ``out[r, o] = items[ids[r, o]]``
  for ``d``-wide item rows, one copy per (request, item).

Each launches its hand-written CUDA kernel (``csrc/packed_lookup.cu``) for
CUDA tensors and runs its plain version for CPU tensors; all of them copy
bytes, so they agree bit for bit.  Both wrappers check the ids before a
gather, since the kernels do not.

:func:`clique_lookup` is the reference's routing of the replay's
membership gather through ``packed_lookup`` (``clique_of`` as an
``(n, 1, 1)`` int32 table): host ids up, one gather, clique ids down.
:class:`CliqueLookup` is that call as the replay's ``lookup`` hook on one
device, with its round trips counted and timed.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from . import _build, capture


def packed_lookup_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain gather: ``table[ids]``."""
    return table[ids.to(torch.int64)]


def unpacked_lookup_plain(items: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain row gather: ``items[ids]``, (R, omega) ids -> (R, omega, d)."""
    return items[ids.to(torch.int64)]


def _check_ids(name: str, ids: torch.Tensor, n: int) -> None:
    """Raise unless every id lies in [0, n) (reads two values back)."""
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        if int(lo) < 0 or int(hi) >= n:
            raise IndexError(f"{name} id outside [0, {n})")


def packed_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                  ids_checked: bool = False) -> torch.Tensor:
    """table (C, omega, d) any dtype; ids (R,) int32 -> (R, omega, d).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``packed_lookup.launches``).  Unless the caller has
    checked the ids (``ids_checked=True``), the wrapper checks them
    against [0, C) first, which on the card costs a sync.
    """
    if table.device.type == "cpu" and ids.device.type == "cpu":
        if not ids_checked:
            _check_ids("packed_lookup", ids, table.shape[0])
        return packed_lookup_plain(table, ids)
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(
            f"packed_lookup runs on one cuda device or the cpu, got "
            f"{table.device} and {ids.device}")
    if table.dim() != 3 or ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(
            f"packed_lookup needs a (C, omega, d) table and (R,) int32 ids, "
            f"got {tuple(table.shape)} and {tuple(ids.shape)} {ids.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("packed_lookup needs a contiguous table and ids")
    C, omega, d = table.shape
    R = int(ids.shape[0])
    out = torch.empty((R, omega, d), dtype=table.dtype, device=table.device)
    row_bytes = omega * d * table.element_size()
    if R == 0 or row_bytes == 0:
        return out
    if not ids_checked:
        _check_ids("packed_lookup", ids, C)
    launch = _build.function("packed_lookup", "packed_lookup_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p])
    code = launch(table.data_ptr(), ids.data_ptr(), out.data_ptr(), R,
                  row_bytes, _build.stream(table))
    _build.check("packed_lookup", "packed_lookup", code)
    packed_lookup.launches += 1
    return out


packed_lookup.launches = 0


def unpacked_lookup(items: torch.Tensor, ids: torch.Tensor, *,
                    ids_checked: bool = False) -> torch.Tensor:
    """items (n, d) any dtype; ids (R, omega) int32 -> (R, omega, d).

    One copy unit per (request, item), against :func:`packed_lookup`'s one
    per request.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (counted in ``unpacked_lookup.launches``).  Unless the
    caller has checked the ids (``ids_checked=True``), the wrapper checks
    them against [0, n) first, which on the card costs a sync.
    """
    if items.device.type == "cpu" and ids.device.type == "cpu":
        if not ids_checked:
            _check_ids("unpacked_lookup", ids, items.shape[0])
        return unpacked_lookup_plain(items, ids)
    if items.device.type != "cuda" or ids.device != items.device:
        raise ValueError(
            f"unpacked_lookup runs on one cuda device or the cpu, got "
            f"{items.device} and {ids.device}")
    if items.dim() != 2 or ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(
            f"unpacked_lookup needs (n, d) items and (R, omega) int32 ids, "
            f"got {tuple(items.shape)} and {tuple(ids.shape)} {ids.dtype}")
    if not (items.is_contiguous() and ids.is_contiguous()):
        raise ValueError("unpacked_lookup needs contiguous items and ids")
    n, d = items.shape
    R, omega = ids.shape
    out = torch.empty((R, omega, d), dtype=items.dtype, device=items.device)
    row_bytes = d * items.element_size()
    if R * omega == 0 or row_bytes == 0:
        return out
    if not ids_checked:
        _check_ids("unpacked_lookup", ids, n)
    launch = _build.function("packed_lookup", "unpacked_lookup_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p])
    code = launch(items.data_ptr(), ids.data_ptr(), out.data_ptr(), R * omega,
                  row_bytes, _build.stream(items))
    _build.check("packed_lookup", "packed_lookup", code)
    unpacked_lookup.launches += 1
    return out


unpacked_lookup.launches = 0


def clique_lookup(clique_of, items, *, device="cpu",
                  use_kernel: bool = True) -> np.ndarray:
    """Map item ids to clique ids; -1 padding slots stay -1.

    ``clique_of`` (n,) and ``items`` (any shape) are host arrays.  The ids
    are checked against [0, n) here, on the host, before the upload; then
    ``packed_lookup`` (or, with ``use_kernel=False``, its plain version)
    gathers on ``device`` and the result comes back to the host.
    """
    clique_of = np.asarray(clique_of)
    items = np.asarray(items)
    flat = np.maximum(items.reshape(-1), 0)
    n = int(clique_of.shape[0])
    if flat.size and int(flat.max()) >= n:
        raise IndexError(f"item id {int(flat.max())} outside [0, {n})")
    dev = torch.device(device)
    table = torch.as_tensor(clique_of.astype(np.int32)).reshape(-1, 1, 1)
    ids = torch.as_tensor(flat.astype(np.int32))
    if dev.type != "cpu":
        table, ids = table.to(dev), ids.to(dev)
    if use_kernel:
        got = packed_lookup(table, ids, ids_checked=True)
    else:
        got = packed_lookup_plain(table, ids)
    got = got.cpu().numpy().reshape(items.shape)
    return np.where(items < 0, -1, got)


class CliqueLookup:
    """The replay's ``lookup(clique_of, items)`` hook on one device.

    Each call is one round trip: the table and the ids go up, the kernel
    (or the plain gather) runs, the clique ids come down.  ``calls``,
    ``seconds`` and the bytes each way are counted, so a run can report
    what the per-batch lookups cost.
    """

    def __init__(self, device="cpu", use_kernel: bool = True):
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.calls = 0
        self.seconds = 0.0
        self.bytes_up = 0
        self.bytes_down = 0

    def __call__(self, clique_of, items) -> np.ndarray:
        capture.keep_largest(
            "packed_lookup", np.size(items),
            lambda: (np.array(clique_of), np.array(items)))
        t0 = time.perf_counter()
        out = clique_lookup(clique_of, items, device=self.device,
                            use_kernel=self.use_kernel)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes_up += 4 * (int(np.size(clique_of)) + int(np.size(items)))
        self.bytes_down += 4 * int(np.size(items))
        return out

    def stats(self) -> dict:
        return {"lookup_calls": self.calls, "lookup_s": self.seconds,
                "lookup_bytes_up": self.bytes_up,
                "lookup_bytes_down": self.bytes_down}
