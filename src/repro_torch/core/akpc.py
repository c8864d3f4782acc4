"""AKPC configuration (paper Alg. 1); a copy of ``repro.core.akpc.AKPCConfig``.

* Event 1 (every T_CG): Clique Generation Module — Alg. 2 (CRM), Alg. 4
  (adjust previous cliques), Alg. 3 (split oversized + approximate merge),
  run on the device by :mod:`repro_torch.core.cgm` where it admits the
  policy and the prices, else on the host (``AKPCPolicy.on_window``);
* Event 2 (per request): Data Request Handling — Alg. 5;
* Event 3 (expiry): Alg. 6 last-copy keepalive, folded into the anchor.

Ablation variants of the paper (Fig. 5/7/9), as registry names:
* ``akpc``          AKPC                    split=True,  approx_merge=True
* ``akpc_no_acm``   AKPC w/o ACM            split=True,  approx_merge=False
* ``akpc_base``     AKPC w/o CS, w/o ACM    split=False, approx_merge=False

``crm_matmul`` / ``pair_edges`` are the host clique generation's hooks for
``H^T H`` and ``M A M^T``; ``kernels="auto"`` wires the port's CUDA kernels
``crm_update`` / ``clique_pair_edges`` in when the replay runs on CUDA
(:mod:`repro_torch.kernels.autowire`), ``"off"`` keeps the numpy paths.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .cost import CostParams
from .engine import CachingCharge


@dataclasses.dataclass
class AKPCConfig:
    params: CostParams = dataclasses.field(default_factory=CostParams)
    t_cg: float = 50.0               # clique-generation period (Fig. 3)
    top_frac: float = 0.1            # CRM restricted to top-10% items (§V.A)
    # hot-set denominator: "window" = fraction of the window's distinct
    # accessed items (paper §V.A), "catalog" = historical fraction of n
    top_frac_of: str = "window"
    enable_split: bool = True        # CS  module
    enable_approx_merge: bool = True # ACM module
    caching_charge: CachingCharge = "requested"
    seed_new_cliques: bool = True
    # requests per replay step; None = event-balanced default
    batch_size: int | None = None
    # host clique-generation hooks; None + kernels="auto" wires the CUDA
    # kernels in when the replay runs on CUDA
    crm_matmul: Callable | None = None
    pair_edges: Callable | None = None
    kernels: str = "auto"            # "auto" | "off"
