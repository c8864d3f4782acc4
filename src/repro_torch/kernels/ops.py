"""Public hooks around the port's kernels (the port of ``repro.kernels.ops``).

Each hook runs the port's wrapper on the device of its arguments: the
hand-written CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  ``crm_matmul`` and ``pair_edges`` are the host clique
generation's hooks and take and return host numpy, on an explicit
``device`` (default CUDA), through the same code as the replay's
wiring (:func:`repro_torch.kernels.autowire.cgm_hooks`).
"""
from __future__ import annotations

import numpy as np
import torch

from .autowire import cgm_hooks
from .packed_lookup import packed_lookup, unpacked_lookup
from .segment_reduce import seg_running_argmax, seg_running_max


def _device(device) -> torch.device:
    from ..core.replay import resolve_device

    return resolve_device(device)


def crm_matmul(H, *, device=None) -> np.ndarray:
    """CRM accumulation: H (B, n) one-hot -> (n, n) counts (zero diagonal)."""
    return cgm_hooks(_device(device))[0](np.asarray(H))


def pair_edges(M, A, *, device=None) -> np.ndarray:
    """Merge scores: membership (k, h) x binary CRM (h, h) -> (k, k) union
    edge counts."""
    return cgm_hooks(_device(device))[1](np.asarray(M), np.asarray(A))


def seg_max(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Segmented running max: (L,) or (S, L) values, (L,) start flags."""
    return seg_running_max(values, starts)


def seg_argmax(values: torch.Tensor, starts: torch.Tensor):
    """Segmented running (max, latest argmax) of the same inputs."""
    return seg_running_argmax(values, starts)


def gather_packed(table: torch.Tensor, ids: torch.Tensor, *,
                  ids_checked: bool = False) -> torch.Tensor:
    """Whole packed cliques: (C, omega, d) table, (R,) ids -> (R, omega, d)."""
    return packed_lookup(table, ids, ids_checked=ids_checked)


def gather_unpacked(items: torch.Tensor, ids: torch.Tensor, *,
                    ids_checked: bool = False) -> torch.Tensor:
    """Item rows: (n, d) items, (R, omega) ids -> (R, omega, d)."""
    return unpacked_lookup(items, ids, ids_checked=ids_checked)
