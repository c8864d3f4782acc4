"""Training loop: hindsight windows -> AdamW steps -> LearnedParams.

The port of ``repro.learned.train``.  The host preparation is the
reference's, verbatim: hindsight labels (:mod:`labels`), the feature
means and stds, padding of the examples to a power-of-two bucket, and the
minibatch indices drawn once from ``np.random.default_rng(cfg.seed)``,
importance-sampled in proportion to the hindsight cost delta
``|cost_keep - cost_evict|`` (so the step loss is a plain mean and the
weight-0 rows and the padding are never drawn).

:func:`train_steps` is the counterpart of the reference's compiled
``_trainer`` body: ``cfg.steps`` forward / backward / AdamW passes over
tensors on one device, then the ``wt``-weighted loss over every example.
It copies the reference's arithmetic: f64 parameters and gradients, the
BCE-with-logits loss ``softplus(s) - y * s`` with jax's softplus
(``logaddexp(s, 0)``; torch's ``softplus`` returns ``s`` above its
threshold), and :mod:`repro_torch.optim.adamw`'s dtypes.  The indices are
uploaded once and nothing in the loop reads a value back to the host, so
on the card the loop makes no host sync; the weights come back once.

:func:`train_policy` runs on CUDA unless the caller passes
``device="cpu"``.  :func:`save_learned_params` /
:func:`load_learned_params` persist the result through
:mod:`repro_torch.checkpoint` and refuse a schema mismatch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.cost import CacheEnvironment, CostParams
from ..core.replay import resolve_device
from ..optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)
from .featurize import FEATURE_NAMES, FEATURE_SCHEMA_VERSION
from .labels import hindsight_windows
from .model import LearnedParams, Scorer, warm_params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Knobs for :func:`train_policy` (defaults sized for smoke runs)."""

    steps: int = 200          # minibatch steps
    batch: int = 256          # examples per step
    lr: float = 3e-2
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    warmup_frac: float = 0.1  # warmup_steps = warmup_frac * steps
    warmup_floor: float = 0.1  # short runs: don't start at lr ~ 0
    min_lr_frac: float = 0.05
    d: int = 8                # scorer trunk width
    d_ff: int = 16            # scorer trunk hidden width
    seed: int = 0             # init + minibatch sampling
    keep_factor: float = 1.0  # TTL warm-start threshold factor
    pad_bucket: int = 512     # min example-count bucket (rounded up pow2)


def _bucket(n: int, floor: int) -> int:
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


def adamw_config(cfg: TrainConfig) -> AdamWConfig:
    """The optimiser settings of a :class:`TrainConfig` (the reference's)."""
    return AdamWConfig(
        lr=cfg.lr, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm,
        warmup_steps=max(int(cfg.warmup_frac * cfg.steps), 1),
        total_steps=cfg.steps, min_lr_frac=cfg.min_lr_frac,
        warmup_floor=cfg.warmup_floor)


def _softplus(s: torch.Tensor) -> torch.Tensor:
    """jax's softplus, ``logaddexp(s, 0)``, at every ``s``."""
    return torch.logaddexp(s, torch.zeros_like(s))


def train_steps(scorer: Scorer, X: torch.Tensor, y: torch.Tensor,
                wt: torch.Tensor, idx: torch.Tensor,
                acfg: AdamWConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Train ``scorer`` in place on the padded examples ``X`` (N, F), ``y``
    and ``wt`` (N,): one AdamW step a row of ``idx`` (steps, batch).

    Returns ``(losses (steps,), final)``: each step's minibatch loss and
    the ``wt``-weighted loss over every example after the last step, as
    tensors on the scorer's device (nothing is read back)."""
    params = scorer.tree()
    flat = [p for _, p in tree_leaves(params)]
    state = adamw_init(params)
    idx = idx.to(torch.int64)
    losses = torch.empty(idx.shape[0], dtype=X.dtype, device=X.device)
    for i in range(idx.shape[0]):
        ib = idx[i]
        xb, yb = X.index_select(0, ib), y.index_select(0, ib)
        s = scorer(xb)
        loss = torch.mean(_softplus(s) - yb * s)
        grad_of = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        grads = tree_map(lambda p: grad_of[id(p)], params)
        with torch.no_grad():
            new, state, _ = adamw_update(acfg, grads, state, params)
            for (_, p), (_, q) in zip(tree_leaves(params), tree_leaves(new)):
                p.copy_(q)
            losses[i] = loss
    with torch.no_grad():
        s = scorer(X)
        final = torch.sum(wt * (_softplus(s) - y * s)) / torch.maximum(
            torch.sum(wt), torch.full((), 1e-12, dtype=wt.dtype,
                                      device=wt.device))
    return losses, final


def train_policy(trace, env: CacheEnvironment | None = None,
                 cfg: TrainConfig | None = None, *, t_cg: float = 50.0,
                 params: CostParams | None = None,
                 cost_model="table1", device=None) -> LearnedParams:
    """Hindsight-label ``trace``'s windows and fit the keep/evict scorer on
    ``device`` (default CUDA).

    Starts from the TTL-equivalent warm start (:func:`model.warm_params`),
    so on degenerate inputs (no windows, or no example with a nonzero cost
    delta) it returns the warm start untouched.
    """
    cfg = cfg or TrainConfig()
    dev = resolve_device(device)
    params = params or (env.params if env is not None else CostParams())
    env = CacheEnvironment.resolve(env, trace, params)
    X, y, wt = hindsight_windows(trace, env, t_cg, params=params,
                                 cost_model=cost_model)
    lp = warm_params(params.lam, params.mu, t_cg, cfg.keep_factor,
                     seed=cfg.seed, d=cfg.d, d_ff=cfg.d_ff)
    n = X.shape[0]
    w_sum = float(wt.sum())
    if n == 0 or w_sum <= 0.0:
        return lp

    lp.mu = X.mean(axis=0)
    lp.sd = np.maximum(X.std(axis=0), 1e-9)
    n_pad = _bucket(n, cfg.pad_bucket)
    Xp = np.zeros((n_pad, X.shape[1]), np.float64)
    yp = np.zeros(n_pad, np.float64)
    wp = np.zeros(n_pad, np.float64)
    Xp[:n], yp[:n], wp[:n] = X, y, wt

    rng = np.random.default_rng(cfg.seed)
    idx = rng.choice(n, size=(cfg.steps, cfg.batch),
                     p=wt / w_sum).astype(np.int32)
    scorer = Scorer(lp, device=dev)

    def up(a):
        return torch.from_numpy(a).to(dev)

    train_steps(scorer, up(Xp), up(yp), up(wp), up(idx),
                           adamw_config(cfg))
    lp.w = scorer.to_params().w
    return lp


def save_learned_params(lp: LearnedParams, directory: str,
                        step: int = 0, meta: dict | None = None) -> str:
    """Persist trained params through :mod:`repro_torch.checkpoint`."""
    from ..checkpoint import save_checkpoint

    m = {"kind": "learned_params", "schema": int(lp.schema),
         "feature_names": list(lp.feature_names)}
    if meta:
        m.update(meta)
    return save_checkpoint(directory, step, lp.tree(), m)


def load_learned_params(directory: str,
                        step: int | None = None) -> LearnedParams:
    """Inverse of :func:`save_learned_params` (newest step by default);
    refuses params of another feature schema."""
    from ..checkpoint import latest_step, load_checkpoint_tree

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {directory!r}")
    tree, meta = load_checkpoint_tree(directory, step)
    lp = LearnedParams.from_tree(tree)
    names = meta.get("feature_names")
    if names is not None:
        lp.feature_names = tuple(names)
    if lp.schema != FEATURE_SCHEMA_VERSION or lp.feature_names != FEATURE_NAMES:
        raise ValueError(
            f"checkpoint schema v{lp.schema} {lp.feature_names} does not "
            f"match featurizer v{FEATURE_SCHEMA_VERSION} {FEATURE_NAMES}")
    return lp
