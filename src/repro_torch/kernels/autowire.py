"""Device wiring of the host clique generation's kernel hooks.

The port of ``repro.kernels.autowire.default_cgm_hooks``: the AKPC
policy's host clique generation takes two optional hooks, ``crm_matmul``
(Alg. 2, ``H -> H^T H``) and ``pair_edges`` (Alg. 3, ``(M, A) -> M A
M^T``).  With ``AKPCConfig.kernels == "auto"`` the reference wires its
Pallas kernels in when a TPU is attached; the port wires its CUDA kernels
``crm_update`` and ``clique_pair_edges`` in when the replay runs on CUDA.
Each hook takes host numpy, uploads it once, runs the kernel (or, with
``use_kernels=False``, its plain version on the same card) and returns
host numpy.  On the CPU there are no hooks, and the numpy paths of
``core.crm`` / ``core.cliques`` run, as in the reference without a TPU.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import capture
from .clique_density import clique_pair_edges, clique_pair_edges_plain
from .crm_update import crm_update, crm_update_plain


def default_cgm_hooks(device, use_kernels: bool = True
                      ) -> tuple[Callable | None, Callable | None]:
    """(crm_matmul, pair_edges) on ``device``, or (None, None) on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None, None
    mm_fn = crm_update if use_kernels else crm_update_plain
    pe_fn = clique_pair_edges if use_kernels else clique_pair_edges_plain

    def crm_matmul(H):
        capture.keep_largest("crm_update", np.size(H), lambda: (H.copy(),))
        Hd = torch.as_tensor(np.ascontiguousarray(H, np.float32)).to(dev)
        return mm_fn(Hd).cpu().numpy()

    def pair_edges(M, A):
        capture.keep_largest("clique_pair_edges", np.size(M),
                             lambda: (M.copy(), A.copy()))
        Md = torch.as_tensor(np.ascontiguousarray(M, np.float32)).to(dev)
        Ad = torch.as_tensor(np.ascontiguousarray(A, np.float32)).to(dev)
        return pe_fn(Md, Ad).cpu().numpy()

    return crm_matmul, pair_edges
