"""CRM co-occurrence counts (paper Alg. 2): ``H^T H`` with a zero diagonal.

The port of ``repro.kernels.crm_update`` (TPU kernel ``crm_update``, Pallas
body ``_crm_kernel``).  :func:`crm_update` launches the hand-written CUDA
kernel ``csrc/crm_update.cu`` for a CUDA tensor and runs the plain version
:func:`crm_update_plain` for a CPU tensor.  Both give exact integer counts
in float32, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: rows of H above which the float32 counts could lose exactness
F32_EXACT = 1 << 24


def crm_update_plain(H: torch.Tensor) -> torch.Tensor:
    """The twin of ``crm_update_jnp``: float32 ``H^T H``, zero diagonal."""
    Hf = H.to(torch.float32)
    out = Hf.T @ Hf
    return out * (1.0 - torch.eye(H.shape[1], dtype=torch.float32,
                                  device=H.device))


def crm_update(H: torch.Tensor) -> torch.Tensor:
    """H (rows, h) 0/1 float32 -> (h, h) float32 co-occurrence counts.

    ``H`` may be the leading columns of a wider buffer (unit column
    stride, any row stride).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in ``crm_update.launches``).
    """
    if H.device.type == "cpu":
        return crm_update_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"crm_update runs on cuda or cpu, not {H.device}")
    if H.dtype != torch.float32 or H.dim() != 2:
        raise ValueError(
            f"crm_update needs a 2-D float32 H, got {H.dtype} {tuple(H.shape)}")
    rows, h = H.shape
    if H.stride(1) != 1 or (rows > 1 and H.stride(0) < h):
        raise ValueError("crm_update needs unit column stride and rows apart")
    if rows >= F32_EXACT:
        raise ValueError(f"{rows} rows reach the float32 exactness bound 2**24")
    out = torch.zeros((h, h), dtype=torch.float32, device=H.device)
    launch = _build.function("crm_update", "crm_update_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    code = launch(H.data_ptr(), out.data_ptr(), rows, h, max(H.stride(0), h),
                  torch.cuda.current_stream(H.device).cuda_stream)
    _build.check("crm_update", "crm_update", code)
    crm_update.launches += 1
    return out


crm_update.launches = 0
