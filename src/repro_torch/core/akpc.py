"""AKPC configuration (paper Alg. 1) and the legacy entry points; the port
of ``repro.core.akpc``.

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

``run_akpc`` / ``run_akpc_variant`` are thin shims over the registry and
:func:`~repro_torch.core.policy.run_policy`, kept for the original batch
API; they run on ``device`` (default CUDA) like every entry point.

``crm_matmul`` / ``pair_edges`` are the host clique generation's hooks for
``H^T H`` and ``M A M^T``; ``kernels="auto"`` wires the port's CUDA kernels
``crm_update`` / ``clique_pair_edges`` in when the replay runs on CUDA
(:mod:`repro_torch.kernels.autowire`), ``"off"`` keeps the numpy paths.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..traces.loader import Trace
from .cost import CostBreakdown, CostParams
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


@dataclasses.dataclass
class AKPCResult:
    """Legacy result type of ``run_akpc`` (RunResult subsumes it)."""

    costs: CostBreakdown
    clique_sizes: np.ndarray         # sizes of all cliques, final window
    size_history: list[np.ndarray]   # per-window non-singleton size arrays
    n_windows: int
    cg_seconds: float                # total clique-generation wall time
    config: AKPCConfig

    @property
    def total(self) -> float:
        return self.costs.total


def run_akpc(trace: Trace, cfg: AKPCConfig | None = None, *,
             device=None) -> AKPCResult:
    """Batch-API shim over ``AKPCPolicy`` + ``run_policy`` on ``device``."""
    from .policy import AKPCPolicy, run_policy

    cfg = cfg or AKPCConfig()
    res = run_policy(AKPCPolicy(cfg), trace, device=device)
    return AKPCResult(
        costs=res.costs,
        clique_sizes=res.clique_sizes,
        size_history=res.size_history,
        n_windows=res.n_windows,
        cg_seconds=res.cg_seconds,
        config=cfg,
    )


def run_akpc_variant(
    trace: Trace,
    params: CostParams,
    *,
    split: bool = True,
    approx_merge: bool = True,
    t_cg: float = 50.0,
    top_frac: float = 0.1,
    caching_charge: CachingCharge = "requested",
    device=None,
) -> AKPCResult:
    """Convenience wrapper for the paper's ablation variants."""
    return run_akpc(
        trace,
        AKPCConfig(
            params=params,
            t_cg=t_cg,
            top_frac=top_frac,
            enable_split=split,
            enable_approx_merge=approx_merge,
            caching_charge=caching_charge,
        ),
        device=device,
    )
