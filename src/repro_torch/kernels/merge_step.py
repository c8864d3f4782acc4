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


def merge_density(X: torch.Tensor, sizes: torch.Tensor, omega: int,
                  gamma32: float, n_act: int | None = None) -> torch.Tensor:
    """X (S, S) float32 pair edges, sizes (S,) int32 -> D (S, S) float32.

    ``omega`` and ``gamma32`` are host scalars (gamma is rounded to
    float32 first).  ``n_act=None`` is the TPU kernel's function; a host
    int ``n_act=k`` in [0, S] also sets -2 on the diagonal and outside the
    leading k x k block.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``merge_density.launches``).
    """
    k = _checked_n_act(n_act, X.shape[0])
    if X.device.type == "cpu" and sizes.device.type == "cpu":
        return merge_density_plain(X, sizes, omega, gamma32, k)
    if X.device.type != "cuda" or sizes.device != X.device:
        raise ValueError(
            f"merge_density runs on one cuda device or the cpu, got "
            f"{X.device} and {sizes.device}")
    if X.dtype != torch.float32 or sizes.dtype != torch.int32:
        raise ValueError("merge_density needs float32 X and int32 sizes")
    S = X.shape[0]
    if X.shape != (S, S) or sizes.shape != (S,):
        raise ValueError(
            f"merge_density needs X (S, S) and sizes (S,), got "
            f"{tuple(X.shape)} and {tuple(sizes.shape)}")
    if not (X.is_contiguous() and sizes.is_contiguous()):
        raise ValueError("merge_density needs contiguous X and sizes")
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


merge_density.launches = 0
