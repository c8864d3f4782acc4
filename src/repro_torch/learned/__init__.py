"""The learned keep-or-not cache policy (port of ``repro.learned``).

Three layers over the caching core:

* :mod:`featurize` — per-window, per-item features with a frozen schema
  version, in numpy f64 (the serving path) and a torch twin;
* :mod:`train` — hindsight-labeled windows (:mod:`labels`) fitted by an
  AdamW step loop over a small gated MLP (:mod:`model`,
  :mod:`repro_torch.optim.adamw`) on the card, ``train_policy(trace, env,
  cfg) -> LearnedParams``, persisted through :mod:`repro_torch.checkpoint`;
* :mod:`policy` — the ``learned`` keep-or-not policy (registered in
  :mod:`repro_torch.core.policy`), which scores each window on the host
  and serves through every replay.
"""
from .featurize import (
    FEATURE_NAMES,
    FEATURE_SCHEMA_VERSION,
    features_np,
    features_torch,
    init_stats,
    update_stats,
    window_co_degree,
)
from .labels import hindsight_windows
from .model import (
    LearnedParams,
    Scorer,
    forward_np,
    forward_torch,
    init_params,
    warm_params,
)
from .policy import LearnedPolicy
from .train import (
    TrainConfig,
    load_learned_params,
    save_learned_params,
    train_policy,
)

__all__ = [
    "FEATURE_NAMES",
    "FEATURE_SCHEMA_VERSION",
    "LearnedParams",
    "LearnedPolicy",
    "Scorer",
    "TrainConfig",
    "features_np",
    "features_torch",
    "forward_np",
    "forward_torch",
    "hindsight_windows",
    "init_params",
    "init_stats",
    "load_learned_params",
    "save_learned_params",
    "train_policy",
    "update_stats",
    "warm_params",
    "window_co_degree",
]
