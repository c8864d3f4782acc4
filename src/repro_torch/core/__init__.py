"""The AKPC replay with on-device clique generation (port of ``repro.core``)."""
from .akpc import AKPCConfig
from .cliques import CliquePartition
from .cost import (
    CacheEnvironment,
    CostBreakdown,
    CostModel,
    CostParams,
    get_cost_model,
)
from .crm import WindowCRM
from .engine import CacheState, ReplayEngine
from .policy import AKPCPolicy, RunResult, get_policy, run_policy
from .replay import TorchReplayEngine, run_policy_torch

__all__ = [
    "AKPCConfig",
    "AKPCPolicy",
    "CacheEnvironment",
    "CacheState",
    "CliquePartition",
    "CostBreakdown",
    "CostModel",
    "CostParams",
    "ReplayEngine",
    "RunResult",
    "TorchReplayEngine",
    "WindowCRM",
    "get_cost_model",
    "get_policy",
    "run_policy",
    "run_policy_torch",
]
