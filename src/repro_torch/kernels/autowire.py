"""Device wiring of the host clique generation's kernel hooks.

The port of ``repro.kernels.autowire.default_cgm_hooks``: the AKPC
policy's host clique generation takes two optional hooks, ``crm_matmul``
(Alg. 2, ``H -> H^T H``) and ``pair_edges`` (Alg. 3, ``(M, A) -> M A
M^T``).  With ``AKPCConfig.kernels == "auto"`` the reference wires its
Pallas kernels in when a TPU is attached; the port wires its CUDA kernels
``crm_update`` and ``clique_pair_edges`` in when the replay runs on CUDA.
Each hook takes host numpy, uploads it once, runs the kernel (or, with
``use_kernels=False``, its plain version on the same card) and returns
host numpy; its uploads and its read-back are the spans
``host_cgm.upload`` and ``host_cgm.readback``.  ``crm_matmul`` also
takes the window's hot id lists (:meth:`CrmMatmul.from_ids`, which
``core.crm.build_window_crm`` prefers): the (B, d) int32 ids cross the
bus, and ``H`` is built on the device (span ``host_cgm.incidence``).  On
the CPU there are no hooks, and the numpy paths of ``core.crm`` /
``core.cliques`` run, as in the reference without a TPU.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..spans import span
from . import capture
from .clique_density import clique_pair_edges, clique_pair_edges_plain
from .crm_update import crm_update, crm_update_plain


def default_cgm_hooks(device, use_kernels: bool = True
                      ) -> tuple[Callable | None, Callable | None]:
    """(crm_matmul, pair_edges) on ``device``, or (None, None) on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None, None
    return cgm_hooks(dev, use_kernels)


def incidence_from_ids(ids: torch.Tensor, h: int) -> torch.Tensor:
    """The (B, h) 0/1 float32 incidence of (B, d) hot ids (-1: padding or a
    cold item) on the ids' device, with no host sync: one zeroed flat
    buffer of B * h + 1 elements, every id at ``row * h + id`` and every
    -1 at the one trash element past the end, set by ``index_fill_`` (an
    id repeated in a request sets the same one).  Returns the contiguous
    leading B * h elements, row stride h, equal to
    :func:`~repro_torch.core.crm.incidence_matrix`."""
    B = ids.shape[0]
    rows = torch.arange(B, dtype=torch.int64, device=ids.device)[:, None]
    pos = torch.where(ids >= 0, rows * h + ids, B * h).reshape(-1)
    flat = torch.zeros(B * h + 1, dtype=torch.float32, device=ids.device)
    flat.index_fill_(0, pos, 1.0)
    return flat[:B * h].view(B, h)


class CrmMatmul:
    """Alg. 2's hook on ``device``: ``(H) -> H^T H`` from a host ``H``, and
    :meth:`from_ids`, which builds ``H`` on the device from the window's
    hot id lists.  ``id_windows`` / ``id_bytes`` count the windows
    :meth:`from_ids` built and the bytes of ids it uploaded."""

    def __init__(self, device: torch.device, fn: Callable):
        self.device = device
        self._fn = fn
        self.id_windows = 0
        self.id_bytes = 0

    def __call__(self, H):
        capture.keep_largest("crm_update", np.size(H), lambda: (H.copy(),))
        with span("host_cgm.upload"):
            Hd = torch.as_tensor(np.ascontiguousarray(H, np.float32)).to(
                self.device)
        out = self._fn(Hd)
        with span("host_cgm.readback"):
            return out.cpu().numpy()

    def from_ids(self, compact, h: int):
        """(B, d) int32 hot ids (-1: none) -> (h, h) counts as host numpy:
        the ids uploaded once, ``H`` built where the kernel runs
        (:func:`incidence_from_ids`), the kernel on it."""
        ids = np.ascontiguousarray(compact, np.int32)
        with span("host_cgm.upload"):
            ids_d = torch.as_tensor(ids).to(self.device)
        with span("host_cgm.incidence"):
            H = incidence_from_ids(ids_d, h)
        capture.keep_largest("crm_update", H.numel(), lambda: (H.clone(),))
        out = self._fn(H)
        self.id_windows += 1
        self.id_bytes += ids.nbytes
        with span("host_cgm.readback"):
            return out.cpu().numpy()


def cgm_hooks(device, use_kernels: bool = True) -> tuple[Callable, Callable]:
    """(crm_matmul, pair_edges) on ``device``, host numpy in and out
    (``crm_matmul`` a :class:`CrmMatmul`).  On CPU tensors the wrappers
    run their plain versions."""
    dev = torch.device(device)
    mm_fn = crm_update if use_kernels else crm_update_plain
    pe_fn = clique_pair_edges if use_kernels else clique_pair_edges_plain

    def pair_edges(M, A):
        capture.keep_largest("clique_pair_edges", np.size(M),
                             lambda: (M.copy(), A.copy()))
        with span("host_cgm.upload"):
            Md = torch.as_tensor(np.ascontiguousarray(M, np.float32)).to(dev)
            Ad = torch.as_tensor(np.ascontiguousarray(A, np.float32)).to(dev)
        out = pe_fn(Md, Ad)
        with span("host_cgm.readback"):
            return out.cpu().numpy()

    return CrmMatmul(dev, mm_fn), pair_edges
