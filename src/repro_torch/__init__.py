"""PyTorch/CUDA port of the AKPC packed-cache replayer (``repro`` is the JAX reference).

Imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .core import (
    OPT_BOUND_MODELS,
    LearnedPolicy,
    get_policy,
    list_policies,
    opt_lower_bound,
    run_dp_greedy,
    run_no_packing,
    run_packcache2,
    run_policy,
)

__all__ = [
    "LearnedPolicy",
    "OPT_BOUND_MODELS",
    "get_policy",
    "list_policies",
    "opt_lower_bound",
    "run_dp_greedy",
    "run_no_packing",
    "run_packcache2",
    "run_policy",
]
