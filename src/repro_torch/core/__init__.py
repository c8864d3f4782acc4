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
from .session import CacheSession, load_snapshot
from .sweep import SweepEngine, SweepPoint, sweep_points

__all__ = [
    "AKPCConfig",
    "AKPCPolicy",
    "BasePolicy",
    "CacheEnvironment",
    "CacheSession",
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
    "SweepEngine",
    "SweepPoint",
    "TTLKeepOrNotPolicy",
    "TorchReplayEngine",
    "WindowCRM",
    "get_cost_model",
    "get_policy",
    "load_snapshot",
    "run_policy",
    "run_policy_torch",
    "sweep_points",
]
