"""All-pairs clique union edge counts ``X = M A M^T`` (paper Alg. 3).

The port of ``repro.kernels.clique_density`` (TPU kernel
``clique_pair_edges``, Pallas body ``_density_kernel``).
:func:`clique_pair_edges` launches the hand-written CUDA kernel
``csrc/clique_density.cu`` for CUDA tensors and runs the plain version
:func:`clique_pair_edges_plain` for CPU tensors.  Both give exact integer
counts in float32, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: the kernel keeps two (8, h) float32 strips plus a staging tile in
#: shared memory, which caps h at what one block can hold
SMEM_CAP = 232_448


def clique_pair_edges_plain(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The twin of ``clique_pair_edges_jnp``: two float32 products."""
    Mf = M.to(torch.float32)
    return Mf @ A.to(torch.float32) @ Mf.T


def clique_pair_edges(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """M (S, h) 0/1 float32 membership, A (h, h) 0/1 float32 -> X (S, S).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``clique_pair_edges.launches``).
    """
    if M.device.type == "cpu" and A.device.type == "cpu":
        return clique_pair_edges_plain(M, A)
    if M.device.type != "cuda" or A.device != M.device:
        raise ValueError(
            f"clique_pair_edges runs on one cuda device or the cpu, got "
            f"{M.device} and {A.device}")
    if M.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("clique_pair_edges needs float32 M and A")
    if M.dim() != 2 or A.dim() != 2:
        raise ValueError("clique_pair_edges needs 2-D M and A")
    S, h = M.shape
    if A.shape != (h, h):
        raise ValueError(f"A must be ({h}, {h}), got {tuple(A.shape)}")
    if not (M.is_contiguous() and A.is_contiguous()):
        raise ValueError("clique_pair_edges needs contiguous M and A")
    if h * (h - 1) // 2 >= 1 << 24:
        raise ValueError(f"h={h} puts the edge counts at the float32 "
                         "exactness bound 2**24")
    smem = _build.function("clique_density", "clique_pair_edges_smem_bytes",
                           [ctypes.c_int], ctypes.c_size_t)(h)
    if smem > SMEM_CAP:
        raise ValueError(f"h={h} needs {smem} bytes of shared memory, over "
                         f"the {SMEM_CAP} a block may use")
    X = torch.empty((S, S), dtype=torch.float32, device=M.device)
    launch = _build.function("clique_density", "clique_pair_edges_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    code = launch(M.data_ptr(), A.data_ptr(), X.data_ptr(), S, h,
                  torch.cuda.current_stream(M.device).cuda_stream)
    _build.check("clique_density", "clique_pair_edges", code)
    clique_pair_edges.launches += 1
    return X


clique_pair_edges.launches = 0
