"""CRM co-occurrence counts (paper Alg. 2): ``H^T H`` with a zero diagonal.

The port of ``repro.kernels.crm_update`` (TPU kernel ``crm_update``, Pallas
body ``_crm_kernel``).  :func:`crm_update` launches the hand-written CUDA
kernel ``csrc/crm_update.cu`` for a CUDA tensor and runs the plain version
:func:`crm_update_plain` for a CPU tensor.  The kernel reads ``H`` once and
counts, for each row, every ordered pair of its nonzero columns into the
output, since the replay's ``H`` has at most 5 ones a row; it is right for
any 0/1 ``H``, dense rows included.  It takes one of three paths by ``h``
and the rows, kept in ``crm_update.last_path`` (:data:`PATHS`): ``narrow``
at h <= 32 (a lane a row, several rows a lane); ``mid`` at 32 < h <= 64
once the rows pass one for each warp of the wide grid, 8 * max(1,
1056 // lanes) (a lane a row, its columns one 64-bit mask); ``wide``
otherwise (a warp a row).  For the 0/1 ``H`` the callers pass, those
counts are ``H^T H``; both versions give exact integers in float32
(atomics in any order add integers below 2**24), so they agree bit for
bit.

A laned call takes ``H`` (S, rows, h), one incidence a sweep lane (the
lanes share the window's rows but not their hot sets), and returns (S, h,
h) in one launch, the lane on the grid's y axis.

Shared memory: at h <= 32 a block keeps its (h, h) integer counts and one
mask a row of its rows, at most 33 KB; on the mid path its (h, h)
counts, at most 16 KB; on the wide path each warp keeps a list of 64
nonzero columns and one 32-bit mask per 32 columns, under the 48 KB a
block has by default up to h of about 47,000 (past that the launch asks
for more; the (h, h) output is 8.8 GB there).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: rows of H above which the float32 counts could lose exactness
F32_EXACT = 1 << 24
#: the kernel's paths, by the code ``crm_update_lanes_launch`` reports: h
#: up to 32; 32 < h <= 64 on many rows; any other
PATHS = ("narrow", "mid", "wide")


def crm_update_plain(H: torch.Tensor) -> torch.Tensor:
    """The twin of ``crm_update_jnp``: float32 ``H^T H``, zero diagonal
    (batched over a leading lane axis of a 3-D ``H``)."""
    Hf = H.to(torch.float32)
    out = Hf.transpose(-1, -2) @ Hf
    return out * (1.0 - torch.eye(H.shape[-1], dtype=torch.float32,
                                  device=H.device))


def crm_update(H: torch.Tensor) -> torch.Tensor:
    """H (rows, h) 0/1 float32 -> (h, h) float32 co-occurrence counts; a
    laned H (S, rows, h) -> (S, h, h).

    ``H`` may be the leading columns of a wider buffer (unit column
    stride, any row and lane stride).  CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in ``crm_update.launches``, its
    path kept in ``crm_update.last_path``).
    """
    if H.device.type == "cpu":
        return crm_update_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"crm_update runs on cuda or cpu, not {H.device}")
    if H.dtype != torch.float32 or H.dim() not in (2, 3):
        raise ValueError(
            "crm_update needs a 2-D or laned 3-D float32 H, got "
            f"{H.dtype} {tuple(H.shape)}")
    laned = H.dim() == 3
    Hl = H if laned else H[None]
    lanes, rows, h = Hl.shape
    if Hl.stride(2) != 1 or (rows > 1 and Hl.stride(1) < h):
        raise ValueError("crm_update needs unit column stride and rows apart")
    if rows >= F32_EXACT:
        raise ValueError(f"{rows} rows reach the float32 exactness bound 2**24")
    out = torch.empty((lanes, h, h), dtype=torch.float32, device=H.device)
    launch = _build.function("crm_update", "crm_update_lanes_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    path = ctypes.c_int(-1)
    code = launch(H.data_ptr(), out.data_ptr(), lanes, rows, h,
                  max(Hl.stride(1), h), Hl.stride(0) if lanes > 1 else 0,
                  ctypes.byref(path), _build.stream(H))
    _build.check("crm_update", "crm_update", code)
    crm_update.last_path = PATHS[path.value] if path.value >= 0 else None
    crm_update.launches += 1
    return out if laned else out[0]


crm_update.launches = 0
crm_update.last_path = None
