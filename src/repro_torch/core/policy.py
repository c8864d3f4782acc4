"""Cache-policy layer: the AKPC policies, registry, result type, offline driver.

The port's counterpart of ``repro.core.policy`` for the AKPC family:
``akpc`` and its ablations ``akpc_no_acm`` / ``akpc_base``.  Their clique
generation runs on the device inside the replay
(:func:`repro_torch.core.cgm.replay_cgm`), so :class:`AKPCPolicy` holds
only configuration and the window bookkeeping the replay folds back into
it (previous-window CRM, partition, per-window size history).

The reference's other policies (``no_packing``, ``ttl``, ``packcache``,
``dp_greedy``, ``learned``) replay through the host-schedule scan, which is
port slice 2: :func:`get_policy` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from .akpc import AKPCConfig
from .cliques import CliquePartition
from .cost import CacheEnvironment, CostBreakdown, CostModel, CostParams
from .crm import WindowCRM
from .engine import CachingCharge


@dataclasses.dataclass
class RunResult:
    """What a policy run returns."""

    policy: str
    costs: CostBreakdown
    clique_sizes: np.ndarray         # sizes of all cliques, final partition
    size_history: list[np.ndarray]   # per-window non-singleton size arrays
    n_windows: int
    cg_seconds: float                # host clique-generation time (0 here)
    wall_seconds: float              # end-to-end replay wall time
    config: Any = None               # the policy's config object
    state: Any = None                # final host CacheState of the replay
    loop_stats: dict | None = None   # syncs and loop trips of the device CGM

    @property
    def total(self) -> float:
        return self.costs.total

    @property
    def transfer(self) -> float:
        return self.costs.transfer

    @property
    def caching(self) -> float:
        return self.costs.caching

    def as_dict(self) -> dict:
        d = self.costs.as_dict()
        d.update(
            policy=self.policy,
            n_windows=self.n_windows,
            cg_seconds=self.cg_seconds,
            wall_seconds=self.wall_seconds,
        )
        return d


class AKPCPolicy:
    """Adaptive K-PackCache (the paper's proposed online algorithm, Alg. 1).

    The three ablation variants of Fig. 5/7/9 are registered separately:
    ``akpc`` (split + approximate merge), ``akpc_no_acm`` (split only) and
    ``akpc_base`` (neither; omega unused).
    """

    name = "akpc"

    def __init__(
        self,
        config: AKPCConfig | None = None,
        *,
        params: CostParams | None = None,
        t_cg: float | None = None,
        top_frac: float | None = None,
        top_frac_of: str | None = None,
        split: bool | None = None,
        approx_merge: bool | None = None,
        caching_charge: CachingCharge | None = None,
        seed_new_cliques: bool | None = None,
        batch_size: int | None = None,
        name: str | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        cfg = config or AKPCConfig()
        if params is None and env is not None:
            if cfg.params == CostParams():
                params = env.params
            elif cfg.params != env.params:
                raise ValueError(
                    "config.params and env.params disagree; build the "
                    "environment with the config's CostParams (or pass "
                    "params= explicitly)")
        over = {
            "params": params,
            "t_cg": t_cg,
            "top_frac": top_frac,
            "top_frac_of": top_frac_of,
            "enable_split": split,
            "enable_approx_merge": approx_merge,
            "caching_charge": caching_charge,
            "seed_new_cliques": seed_new_cliques,
            "batch_size": batch_size,
        }
        cfg = dataclasses.replace(
            cfg, **{k: v for k, v in over.items() if v is not None}
        )
        self.config = cfg
        if name is not None:
            self.name = name
        self.params = cfg.params
        self.env = env                  # None = derive from the trace
        self.cost_model = cost_model
        self.t_cg = cfg.t_cg
        self.caching_charge = cfg.caching_charge
        self.seed_new_cliques = cfg.seed_new_cliques
        self.batch_size = cfg.batch_size
        self.bind(0, 0)

    def bind(self, n: int, m: int) -> None:
        """Reset per-run state for a catalog of n items and m servers."""
        self.n = n
        self.m = m
        self._partition: CliquePartition | None = None
        self._prev_crm: WindowCRM | None = None
        self.size_history: list[np.ndarray] = []
        self.n_windows = 0
        self.cg_seconds = 0.0

    def initial_partition(self, trace=None) -> CliquePartition | None:
        return None

    def on_window(self, items, servers, now):
        """Alg. 1 Event 1 on the host: the host clique generation is not
        ported; the replay runs it on the device instead."""
        raise NotImplementedError(
            "the host clique generation is port slice 2; AKPC policies run "
            "their clique generation on the device inside the replay")


_REGISTRY: dict[str, Callable[..., AKPCPolicy]] = {
    "akpc": AKPCPolicy,
    "akpc_no_acm": lambda **kw: AKPCPolicy(
        **{"split": True, "approx_merge": False, "name": "akpc_no_acm", **kw}),
    "akpc_base": lambda **kw: AKPCPolicy(
        **{"split": False, "approx_merge": False, "name": "akpc_base", **kw}),
}

#: the reference's policies that replay through the host-schedule scan
_SLICE_2 = ("no_packing", "ttl", "packcache", "packcache2", "dp_greedy",
            "learned")


def get_policy(name: str, **kwargs) -> AKPCPolicy:
    """Instantiate a registered policy by name (fresh state every call)."""
    if name in _SLICE_2:
        raise NotImplementedError(
            f"policy {name!r} replays through the host-schedule scan, which "
            "is port slice 2; the port runs the AKPC family only")
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def run_policy(
    policy: AKPCPolicy | str,
    trace,
    *,
    device=None,
    batch_size: int | None = None,
) -> RunResult:
    """Replay a full trace under ``policy`` on ``device`` (default CUDA).

    The counterpart of ``repro.core.run_policy(..., backend="jax")``: same
    :class:`RunResult`, state float-for-float equal to the numpy engine,
    costs equal at 1e-9.  ``device=None`` means ``"cuda"`` and raises when
    CUDA is absent; pass ``device="cpu"`` to run the plain versions on the
    CPU.
    """
    from .replay import run_policy_torch

    return run_policy_torch(
        policy, trace, device=device, batch_size=batch_size)

