"""Packed and unpacked gathers, and the replay's item -> clique lookup.

The port of ``repro.kernels.packed_lookup``:

* :func:`packed_lookup` (TPU kernel ``packed_lookup``, Pallas body
  ``_copy_kernel``): ``out[r] = table[ids[r]]`` for whole packed
  ``(omega, d)`` rows, one copy per request;
* :func:`unpacked_lookup` (TPU kernel ``unpacked_lookup``, Pallas body
  ``_copy_reshape_kernel``): the baseline, ``out[r, o] = items[ids[r, o]]``
  for ``d``-wide item rows, one copy per (request, item).

Both launch one row-copy engine (``csrc/packed_lookup.cu``,
``lookup_rows_launch``) for CUDA tensors, which picks a copy path by row
size, alignment and table size and reports it (the wrapper's
``last_path``, one of :data:`PATHS`), and run their plain versions for CPU tensors; all of them
copy bytes, so they agree bit for bit.  Both wrappers check the ids before
a gather, since the kernel does not.

:class:`CliqueLookup` is the reference's routing of the replay's
membership gather through ``packed_lookup`` (``clique_of`` as an
``(n, 1, 1)`` int32 table), as the host schedule's ``lookup`` hook on one
device: the table stays on the device until it changes, the ids go up and
the clique ids come down through pinned buffers, one kernel and one sync a
call.  :func:`clique_lookup` is one such call.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..spans import span
from . import _build, capture

#: the C signature of the engine's launch function
_LAUNCH_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
#: the engine's copy paths, by the code ``lookup_rows_launch`` reports:
#: rows of 4-16 bytes (``narrow``); of a 16-byte multiple below 6 MB from a
#: table of at most 6 MB (``vector``) or a larger one (``sliced``); any
#: other (``ragged``); of a 16-byte multiple of 6 MB or more (``stream``:
#: the expert gathers' multi-MB clique rows, each read once)
PATHS = ("narrow", "vector", "sliced", "ragged", "stream")


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


def _on_card(name: str, src: torch.Tensor, ids: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix."""
    if src.device.type == "cpu" and ids.device.type == "cpu":
        return False
    if src.device.type != "cuda" or ids.device != src.device:
        raise ValueError(f"{name} runs on one cuda device or the cpu, got "
                         f"{src.device} and {ids.device}")
    if not (src.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name} needs a contiguous source and ids")
    return True


def _launch(src: torch.Tensor, ids: torch.Tensor, out: torch.Tensor,
            rows: int, row_bytes: int) -> str:
    """Launch the copy engine; returns the path it took (:data:`PATHS`)."""
    fn = _build.function("packed_lookup", "lookup_rows_launch", _LAUNCH_ARGS)
    path = ctypes.c_int(-1)
    code = fn(src.data_ptr(), src.shape[0], ids.data_ptr(), out.data_ptr(),
              rows, row_bytes, ctypes.byref(path), _build.stream(src))
    _build.check("packed_lookup", "packed_lookup", code)
    return PATHS[path.value]


def packed_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                  ids_checked: bool = False) -> torch.Tensor:
    """table (C, omega, d) any dtype; ids (R,) int32 -> (R, omega, d).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``packed_lookup.launches``, its copy path kept in
    ``packed_lookup.last_path``).  Unless the caller has checked the ids
    (``ids_checked=True``), the wrapper checks them against [0, C) first,
    which on the card costs a sync.
    """
    if not _on_card("packed_lookup", table, ids):
        if not ids_checked:
            _check_ids("packed_lookup", ids, table.shape[0])
        return packed_lookup_plain(table, ids)
    if table.dim() != 3 or ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(
            f"packed_lookup needs a (C, omega, d) table and (R,) int32 ids, "
            f"got {tuple(table.shape)} and {tuple(ids.shape)} {ids.dtype}")
    C, omega, d = table.shape
    R = int(ids.shape[0])
    out = torch.empty((R, omega, d), dtype=table.dtype, device=table.device)
    row_bytes = omega * d * table.element_size()
    if R == 0 or row_bytes == 0:
        return out
    if not ids_checked:
        _check_ids("packed_lookup", ids, C)
    packed_lookup.last_path = _launch(table, ids, out, R, row_bytes)
    packed_lookup.launches += 1
    return out


packed_lookup.launches = 0
packed_lookup.last_path = None


def unpacked_lookup(items: torch.Tensor, ids: torch.Tensor, *,
                    ids_checked: bool = False) -> torch.Tensor:
    """items (n, d) any dtype; ids (R, omega) int32 -> (R, omega, d).

    One copy unit per (request, item), against :func:`packed_lookup`'s one
    per request.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (counted in ``unpacked_lookup.launches``, its copy path kept
    in ``unpacked_lookup.last_path``).  Unless the caller has checked the
    ids (``ids_checked=True``), the wrapper checks them against [0, n)
    first, which on the card costs a sync.
    """
    if not _on_card("unpacked_lookup", items, ids):
        if not ids_checked:
            _check_ids("unpacked_lookup", ids, items.shape[0])
        return unpacked_lookup_plain(items, ids)
    if items.dim() != 2 or ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(
            f"unpacked_lookup needs (n, d) items and (R, omega) int32 ids, "
            f"got {tuple(items.shape)} and {tuple(ids.shape)} {ids.dtype}")
    n, d = items.shape
    R, omega = ids.shape
    out = torch.empty((R, omega, d), dtype=items.dtype, device=items.device)
    row_bytes = d * items.element_size()
    if R * omega == 0 or row_bytes == 0:
        return out
    if not ids_checked:
        _check_ids("unpacked_lookup", ids, n)
    unpacked_lookup.last_path = _launch(items, ids, out, R * omega,
                                        row_bytes)
    unpacked_lookup.launches += 1
    return out


unpacked_lookup.launches = 0
unpacked_lookup.last_path = None


#: pinned staging of the lookups' ids and clique ids, and the ids' device
#: buffer, by device: shared by every CliqueLookup (a call syncs before it
#: returns, so no two calls overlap)
_STAGING: dict = {}


def _staging(device: torch.device, size: int) -> tuple:
    """(up, down, ids) buffers of at least ``size`` int32 for ``device``."""
    bufs = _STAGING.get(device)
    if bufs is None or bufs[0].numel() < size:
        cap = 1 << max(16, (size - 1).bit_length())
        bufs = (torch.empty(cap, dtype=torch.int32, pin_memory=True),
                torch.empty(cap, dtype=torch.int32, pin_memory=True),
                torch.empty(cap, dtype=torch.int32, device=device))
        _STAGING[device] = bufs
    return bufs


class CliqueLookup:
    """The host schedule's ``lookup(clique_of, items)`` hook on one device.

    ``clique_of`` stays on the device and is uploaded again only when it
    differs from the last copy uploaded (compared by value, so an array
    changed in place is caught).  A call checks the ids on the host,
    stages them up and the clique ids down through pinned buffers that
    grow as needed, and runs one gather (the kernel, or with
    ``use_kernel=False`` its plain version) and one sync.  -1 padding
    slots stay -1.  ``calls``, ``seconds``, the ids' bytes each way and
    the table's uploads are counted; a call is the span ``host.lookup``.
    """

    def __init__(self, device=None, use_kernel: bool = True):
        from ..core.replay import resolve_device

        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.calls = 0
        self.seconds = 0.0
        self.bytes_up = 0
        self.bytes_down = 0
        self.table_uploads = 0
        self.table_bytes_up = 0
        self._host: np.ndarray | None = None     # clique_of as uploaded
        self._table: torch.Tensor | None = None  # its (n, 1, 1) int32 copy

    def _resident(self, clique_of: np.ndarray) -> torch.Tensor:
        if (self._host is None or self._host.shape != clique_of.shape
                or not np.array_equal(self._host, clique_of)):
            self._host = clique_of.astype(np.int32)
            self._table = torch.from_numpy(self._host).reshape(-1, 1, 1).to(
                self.device)
            self.table_uploads += 1
            self.table_bytes_up += 4 * int(self._host.size)
        return self._table

    def gather(self, clique_of, items) -> np.ndarray:
        """Clique ids of ``items`` (any shape; -1 pads stay -1), uncounted."""
        clique_of = np.asarray(clique_of)
        items = np.asarray(items)
        R = int(items.size)
        if R == 0:
            return np.zeros(items.shape, np.int32)
        n = int(clique_of.shape[0])
        hi = int(items.max())
        if hi >= n:
            raise IndexError(f"item id {hi} outside [0, {n})")
        pads = int(items.min()) < 0
        flat = (np.maximum(items, 0) if pads else items).reshape(-1)
        table = self._resident(clique_of)
        gather = packed_lookup if self.use_kernel else packed_lookup_plain
        kw = {"ids_checked": True} if self.use_kernel else {}
        if self.device.type == "cpu":
            ids = torch.from_numpy(flat.astype(np.int32))
            got = gather(table, ids, **kw).numpy().reshape(-1)
        else:
            up, down, dev_ids = _staging(self.device, R)
            up.numpy()[:R] = flat
            ids = dev_ids[:R]
            ids.copy_(up[:R], non_blocking=True)
            down[:R].copy_(gather(table, ids, **kw).reshape(-1),
                           non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            got = down.numpy()[:R].copy()
        self.bytes_up += 4 * R
        self.bytes_down += 4 * R
        got = got.reshape(items.shape)
        return np.where(items < 0, -1, got) if pads else got

    def __call__(self, clique_of, items) -> np.ndarray:
        capture.keep_largest(
            "packed_lookup", np.size(items),
            lambda: (np.array(clique_of), np.array(items)))
        t0 = time.perf_counter()
        with span("host.lookup"):
            out = self.gather(clique_of, items)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    def stats(self) -> dict:
        return {"lookup_calls": self.calls, "lookup_s": self.seconds,
                "lookup_bytes_up": self.bytes_up,
                "lookup_bytes_down": self.bytes_down,
                "lookup_table_uploads": self.table_uploads,
                "lookup_table_bytes_up": self.table_bytes_up}


def clique_lookup(clique_of, items, *, device=None,
                  use_kernel: bool = True) -> np.ndarray:
    """Map item ids to clique ids on ``device`` (default CUDA, which must
    be present); -1 padding slots stay -1.  One :class:`CliqueLookup`
    call: the ids are checked on the host, then ``packed_lookup`` (or,
    with ``use_kernel=False``, its plain version) gathers."""
    return CliqueLookup(device, use_kernel).gather(clique_of, items)
