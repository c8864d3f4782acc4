"""All-pairs clique union edge counts ``X = M A M^T`` (paper Alg. 3).

The port of ``repro.kernels.clique_density`` (TPU kernel
``clique_pair_edges``, Pallas body ``_density_kernel``).
:func:`clique_pair_edges` launches the hand-written CUDA kernel
``csrc/clique_density.cu`` for CUDA tensors and runs the plain version
:func:`clique_pair_edges_plain` for CPU tensors.  The kernel lists each
row's nonzero columns of ``M`` (one launch), then sums, a block a row i,
the rows of ``A`` in row i's list into shared memory and each other row's
list over that sum (a second launch): work in proportion to the ones of
``M``, which has at most one a column on the replay's path, and exact for
any 0/1 ``M``.  Both give exact integer counts in float32, so they agree
bit for bit.

Shared memory: a block keeps one (h,) float32 row of ``M A`` and 256 list
entries, 4 h + 1 KB; the float32 exactness bound on h (h(h-1)/2 < 2**24,
so h <= 5793) keeps it at or under 24 KB, within the 48 KB any block may
use.

A laned call takes ``M`` (L, S, h) and ``A`` (L, h, h), one pair a sweep
lane, and returns ``X`` (L, S, S) in one launch of each pass, the lane on
the grid's y axis.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def clique_pair_edges_plain(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The twin of ``clique_pair_edges_jnp``: two float32 products
    (batched over a leading lane axis of 3-D operands)."""
    Mf = M.to(torch.float32)
    return Mf @ A.to(torch.float32) @ Mf.transpose(-1, -2)


def clique_pair_edges(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """M (S, h) 0/1 float32 membership, A (h, h) 0/1 float32 -> X (S, S);
    laned M (L, S, h), A (L, h, h) -> X (L, S, S).

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    two passes (counted once, in ``clique_pair_edges.launches``).
    """
    if M.device.type == "cpu" and A.device.type == "cpu":
        return clique_pair_edges_plain(M, A)
    if M.device.type != "cuda" or A.device != M.device:
        raise ValueError(
            f"clique_pair_edges runs on one cuda device or the cpu, got "
            f"{M.device} and {A.device}")
    if M.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("clique_pair_edges needs float32 M and A")
    if M.dim() != A.dim() or M.dim() not in (2, 3):
        raise ValueError("clique_pair_edges needs 2-D (or laned 3-D) M and A")
    laned = M.dim() == 3
    Ml, Al = (M, A) if laned else (M[None], A[None])
    lanes, S, h = Ml.shape
    if Al.shape != (lanes, h, h):
        raise ValueError(f"A must be ({h}, {h}) a lane, got {tuple(A.shape)}")
    if not (M.is_contiguous() and A.is_contiguous()):
        raise ValueError("clique_pair_edges needs contiguous M and A")
    if h * (h - 1) // 2 >= 1 << 24:
        raise ValueError(f"h={h} puts the edge counts at the float32 "
                         "exactness bound 2**24")
    X = torch.empty((lanes, S, S), dtype=torch.float32, device=M.device)
    # the rows' lists of nonzero columns, then their lengths
    lists = torch.empty((lanes * (S * h + S),), dtype=torch.int32,
                        device=M.device)
    launch = _build.function("clique_density",
                             "clique_pair_edges_lanes_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    code = launch(M.data_ptr(), A.data_ptr(), X.data_ptr(), lists.data_ptr(),
                  lists.data_ptr() + 4 * lanes * S * h, lanes, S, h,
                  _build.stream(M))
    _build.check("clique_density", "clique_pair_edges", code)
    clique_pair_edges.launches += 1
    return X if laned else X[0]


clique_pair_edges.launches = 0
