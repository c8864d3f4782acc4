"""The AKPC packed-cache replay on the device (port of ``repro.core``)."""
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
from .policy import (
    AKPCPolicy,
    BasePolicy,
    DPGreedyPolicy,
    NoPackingPolicy,
    PackCache2Policy,
    RunResult,
    TTLKeepOrNotPolicy,
    get_policy,
    run_policy,
)
from .replay import TorchReplayEngine, run_policy_torch

__all__ = [
    "AKPCConfig",
    "AKPCPolicy",
    "BasePolicy",
    "CacheEnvironment",
    "CacheState",
    "CliquePartition",
    "CostBreakdown",
    "CostModel",
    "CostParams",
    "DPGreedyPolicy",
    "NoPackingPolicy",
    "PackCache2Policy",
    "ReplayEngine",
    "RunResult",
    "TTLKeepOrNotPolicy",
    "TorchReplayEngine",
    "WindowCRM",
    "get_cost_model",
    "get_policy",
    "run_policy",
    "run_policy_torch",
]
