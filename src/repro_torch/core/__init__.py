"""The AKPC packed-cache replay on the device (port of ``repro.core``)."""
from .akpc import AKPCConfig
from .baselines import (
    OPT_BOUND_MODELS,
    opt_lower_bound,
    run_dp_greedy,
    run_no_packing,
    run_packcache2,
)
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
    list_policies,
    run_policy,
)
from .replay import TorchReplayEngine, run_policy_torch
from .session import CacheSession, load_snapshot
from .sweep import SweepEngine, SweepPoint, sweep_points
# last: the learned policy imports the modules above
from ..learned.policy import LearnedPolicy  # noqa: E402

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
    "LearnedPolicy",
    "NoPackingPolicy",
    "OPT_BOUND_MODELS",
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
    "list_policies",
    "load_snapshot",
    "opt_lower_bound",
    "run_dp_greedy",
    "run_no_packing",
    "run_packcache2",
    "run_policy",
    "run_policy_torch",
    "sweep_points",
]
