"""Initial density matrix D of the approximate merge (paper Alg. 3).

The port of ``repro.kernels.merge_step`` (TPU kernel ``merge_density``,
Pallas body ``_merge_density_kernel``):

    within[i] = X[i, i] / 2
    e(i u j)  = (within[i] + within[j]) + X[i, j]
    D[i, j]   = e / e_max  if |i| + |j| == omega and i != j, else -1,
                and -1 where that density is below gamma.

With ``n_act=k`` the same call also applies the act mask that the merge
loop puts on D (``repro.core.cgm_jax._approx_merge``: ``where(actp, D,
-2.0)`` with ``actp = (i < k) & (j < k) & (i != j)``), so the loop's
starting D is one launch.

:func:`merge_density` launches the hand-written CUDA kernel
``csrc/merge_step.cu`` for CUDA tensors and runs the plain version
:func:`merge_density_plain` for CPU tensors.  Both keep the float32
operation order of ``merge_density_jnp`` with one IEEE division, so they
agree bit for bit.

A laned call takes ``X`` (L, S, S) and ``sizes`` (L, S), one merge a sweep
lane, with per-lane ``omega`` (L,) int32, ``gamma32`` (L,) float32 and
``n_act`` (L,) integer (or None) tensors on X's device, and returns D (L,
S, S) in one launch, the lane on the grid's z axis; each lane's ``e_max``
is its omega's, rounded as :func:`e_max32` rounds it.  Nothing of the
knobs goes through the host, so a laned call captures into a CUDA graph;
``act_max``, the largest act count if the caller knows it, picks the
tile height (default S).
"""
from __future__ import annotations

import ctypes
import operator

import numpy as np
import torch

from . import _build


def e_max32(omega: int) -> float:
    """``omega (omega - 1) / 2`` in float64, rounded once to float32."""
    om = float(omega)
    return float(np.float32(om * (om - 1.0) / 2.0))


def merge_density_plain(X: torch.Tensor, sizes: torch.Tensor, omega: int,
                        gamma32: float, n_act: int | None = None
                        ) -> torch.Tensor:
    """The twin of ``merge_density_jnp``, operation for operation, then
    (given ``n_act``) the reference merge's ``where(actp, D, -2.0)``."""
    S = X.shape[0]
    within = torch.diagonal(X) / 2.0
    e_u = (within[:, None] + within[None, :]) + X
    e_max = torch.tensor(e_max32(omega), dtype=torch.float32, device=X.device)
    eye = torch.eye(S, dtype=torch.bool, device=X.device)
    okp = ((sizes[:, None] + sizes[None, :]) == int(omega)) & ~eye
    dens = torch.where(okp, e_u / e_max, -1.0)
    gm = torch.tensor(float(np.float32(gamma32)), dtype=torch.float32,
                      device=X.device)
    D = torch.where(dens >= gm, dens, -1.0)
    if n_act is None:
        return D
    act = torch.arange(S, device=X.device) < n_act
    actp = act[:, None] & act[None, :] & ~eye
    return torch.where(actp, D, -2.0)


def _checked_n_act(n_act, S: int) -> int | None:
    if n_act is None:
        return None
    k = operator.index(n_act)
    if not 0 <= k <= S:
        raise ValueError(f"merge_density needs 0 <= n_act <= S = {S}, "
                         f"got {k}")
    return k


def merge_density_lanes_plain(X: torch.Tensor, sizes: torch.Tensor,
                              omega: torch.Tensor, gamma32: torch.Tensor,
                              n_act: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """The laned twin: :func:`merge_density_plain` in every lane at once,
    with lane ``l``'s own omega, gamma and act count (clamped to [0, S])."""
    S = X.shape[1]
    dev = X.device
    om = omega.to(torch.int64)
    within = torch.diagonal(X, dim1=1, dim2=2) / 2.0
    e_u = (within[:, :, None] + within[:, None, :]) + X
    omf = om.to(torch.float64)
    e_max = (omf * (omf - 1.0) / 2.0).to(torch.float32)
    eye = torch.eye(S, dtype=torch.bool, device=dev)
    okp = (((sizes[:, :, None] + sizes[:, None, :]) == om[:, None, None])
           & ~eye)
    dens = torch.where(okp, e_u / e_max[:, None, None], -1.0)
    gm = gamma32.to(torch.float32)[:, None, None]
    D = torch.where(dens >= gm, dens, -1.0)
    if n_act is None:
        return D
    k = n_act.to(torch.int64).clamp(0, S)
    act = torch.arange(S, device=dev)[None, :] < k[:, None]
    actp = act[:, :, None] & act[:, None, :] & ~eye
    return torch.where(actp, D, -2.0)


def merge_density(X: torch.Tensor, sizes: torch.Tensor, omega,
                  gamma32, n_act=None, act_max: int | None = None
                  ) -> torch.Tensor:
    """X (S, S) float32 pair edges, sizes (S,) int32 -> D (S, S) float32;
    laned X (L, S, S), sizes (L, S) -> D (L, S, S).

    Unlaned, ``omega`` and ``gamma32`` are host scalars (gamma is rounded
    to float32 first).  ``n_act=None`` is the TPU kernel's function; a host
    int ``n_act=k`` in [0, S] also sets -2 on the diagonal and outside the
    leading k x k block.  Laned, ``omega`` (L,) int32, ``gamma32`` (L,)
    float32 and ``n_act`` (None or (L,) integer, each clamped to [0, S])
    are tensors on X's device, ``act_max`` a host bound on the act counts
    (the tile height's hint).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in ``merge_density.launches``).
    """
    if X.dim() == 3:
        return _merge_density_lanes(X, sizes, omega, gamma32, n_act,
                                    act_max)
    k = _checked_n_act(n_act, X.shape[0])
    if X.device.type == "cpu" and sizes.device.type == "cpu":
        return merge_density_plain(X, sizes, omega, gamma32, k)
    _check_operands(X, sizes)
    S = X.shape[0]
    if X.shape != (S, S) or sizes.shape != (S,):
        raise ValueError(
            f"merge_density needs X (S, S) and sizes (S,), got "
            f"{tuple(X.shape)} and {tuple(sizes.shape)}")
    D = torch.empty((S, S), dtype=torch.float32, device=X.device)
    launch = _build.function("merge_step", "merge_density_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p])
    code = launch(X.data_ptr(), sizes.data_ptr(), D.data_ptr(), S,
                  -1 if k is None else k, int(omega),
                  float(np.float32(gamma32)), e_max32(omega), _build.stream(X))
    _build.check("merge_step", "merge_density", code)
    merge_density.launches += 1
    return D


def _check_operands(X, sizes) -> None:
    if X.device.type != "cuda" or sizes.device != X.device:
        raise ValueError(
            f"merge_density runs on one cuda device or the cpu, got "
            f"{X.device} and {sizes.device}")
    if X.dtype != torch.float32 or sizes.dtype != torch.int32:
        raise ValueError("merge_density needs float32 X and int32 sizes")
    if not (X.is_contiguous() and sizes.is_contiguous()):
        raise ValueError("merge_density needs contiguous X and sizes")


def _merge_density_lanes(X, sizes, omega, gamma32, n_act, act_max):
    L, S = X.shape[0], X.shape[1]
    if X.shape != (L, S, S) or sizes.shape != (L, S):
        raise ValueError(
            f"laned merge_density needs X (L, S, S) and sizes (L, S), got "
            f"{tuple(X.shape)} and {tuple(sizes.shape)}")
    knobs = (omega, gamma32) + (() if n_act is None else (n_act,))
    if not all(isinstance(t, torch.Tensor) and t.shape == (L,)
               and t.device == X.device for t in knobs):
        raise ValueError("laned merge_density needs (L,) omega, gamma32 "
                         "and n_act tensors on X's device")
    if X.device.type == "cpu" and sizes.device.type == "cpu":
        return merge_density_lanes_plain(X, sizes, omega, gamma32, n_act)
    _check_operands(X, sizes)
    om = omega.to(torch.int32).contiguous()
    gm = gamma32.to(torch.float32).contiguous()
    acts = None if n_act is None else n_act.to(torch.int32).contiguous()
    lim = S if act_max is None or n_act is None else min(S, max(
        0, operator.index(act_max)))
    D = torch.empty((L, S, S), dtype=torch.float32, device=X.device)
    launch = _build.function("merge_step", "merge_density_lanes_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    code = launch(X.data_ptr(), sizes.data_ptr(), D.data_ptr(), L, S,
                  om.data_ptr(), gm.data_ptr(),
                  None if acts is None else acts.data_ptr(), lim,
                  _build.stream(X))
    _build.check("merge_step", "merge_density", code)
    merge_density.launches += 1
    return D


merge_density.launches = 0
