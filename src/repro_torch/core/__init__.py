"""The AKPC packed-cache replay on the device (port of ``repro.core``).

Every public name of ``repro.core`` has its counterpart here, the JAX
backend's as the device replay's (``JaxReplayEngine`` ->
:class:`TorchReplayEngine`, ``run_policy_jax`` -> :func:`run_policy_torch`,
``JAX_COST_MODELS`` -> :data:`DEVICE_COST_MODELS`), except
``BatchOutcome``: the port's host engine keeps state only and has no
``handle_batch`` (the per-request checks read the device replay's
per-step record instead).
"""
from .akpc import AKPCConfig, AKPCResult, run_akpc, run_akpc_variant
from .baselines import (
    OPT_BOUND_MODELS,
    opt_lower_bound,
    run_dp_greedy,
    run_no_packing,
    run_packcache2,
)
from .cliques import CliquePartition, generate_cliques
from .competitive import (
    AdversarySetup,
    adversarial_trace,
    generalized_bound,
    generalized_per_request_ratio_check,
    per_request_ratio_check,
    replay_adversary,
)
from .cost import (
    CacheEnvironment,
    CostBreakdown,
    CostModel,
    CostParams,
    HeterogeneousCostModel,
    Table1CostModel,
    TieredCostModel,
    competitive_bound,
    competitive_bound_corrected,
    competitive_bound_env,
    get_cost_model,
    list_cost_models,
    register_cost_model,
)
from .crm import WindowCRM, build_window_crm
from .engine import (
    DEFAULT_BATCH_SIZE,
    BatchEvents,
    CacheState,
    ReplayEngine,
    batch_events,
    match_partitions,
)
from .policy import (
    AKPCPolicy,
    BasePolicy,
    CachePolicy,
    DPGreedyPolicy,
    NoPackingPolicy,
    PackCache2Policy,
    RunResult,
    TTLKeepOrNotPolicy,
    get_policy,
    greedy_pair_matching,
    list_policies,
    register_policy,
    run_policy,
)
from .replay import DEVICE_COST_MODELS, TorchReplayEngine, run_policy_torch
from .session import CacheSession, load_snapshot
from .sweep import SweepEngine, SweepPoint, sweep_points
# last: the learned policy imports the modules above
from ..learned.policy import LearnedPolicy  # noqa: E402

__all__ = [
    "AKPCConfig",
    "AKPCPolicy",
    "AKPCResult",
    "AdversarySetup",
    "BasePolicy",
    "BatchEvents",
    "CacheEnvironment",
    "CachePolicy",
    "CacheSession",
    "CacheState",
    "CliquePartition",
    "CostBreakdown",
    "CostModel",
    "CostParams",
    "DEFAULT_BATCH_SIZE",
    "DEVICE_COST_MODELS",
    "DPGreedyPolicy",
    "HeterogeneousCostModel",
    "LearnedPolicy",
    "NoPackingPolicy",
    "OPT_BOUND_MODELS",
    "PackCache2Policy",
    "ReplayEngine",
    "RunResult",
    "SweepEngine",
    "SweepPoint",
    "TTLKeepOrNotPolicy",
    "Table1CostModel",
    "TieredCostModel",
    "TorchReplayEngine",
    "WindowCRM",
    "adversarial_trace",
    "batch_events",
    "build_window_crm",
    "competitive_bound",
    "competitive_bound_corrected",
    "competitive_bound_env",
    "generalized_bound",
    "generalized_per_request_ratio_check",
    "generate_cliques",
    "get_cost_model",
    "get_policy",
    "greedy_pair_matching",
    "list_cost_models",
    "list_policies",
    "load_snapshot",
    "match_partitions",
    "opt_lower_bound",
    "per_request_ratio_check",
    "register_cost_model",
    "register_policy",
    "replay_adversary",
    "run_akpc",
    "run_akpc_variant",
    "run_dp_greedy",
    "run_no_packing",
    "run_packcache2",
    "run_policy",
    "run_policy_torch",
    "sweep_points",
]
