"""The learned keep/evict scorer: linear skip + small gated-MLP residual.

The port of ``repro.learned.model``:

    score(x) = z @ w_lin + b + mlp(z @ w_in) @ w_out,   z = (x - mu) / sd

where ``mlp`` is one SwiGLU block (``silu(h @ wi) * (h @ wg) @ wo``).  An
item is KEPT iff its score is >= 0.

Two forwards over the same parameter tree:

* :func:`forward_np` — numpy float64, the canonical serving path (the
  policy decides keep/evict with it on the host, for every replay);
* :func:`forward_torch` — the torch twin of the reference's
  ``forward_jnp``, which the trainer differentiates through;
  :class:`Scorer` holds the tree's leaves as parameters under their
  names.

:func:`warm_params` zeroes the MLP head and sets the linear part to the
TTL break-even rule on ``log_window_count``, so an untrained ``learned``
policy reproduces the TTL baseline's decisions exactly.  The reference
draws its trunk from ``jax.random``; :func:`init_params` draws it from a
``torch.Generator``, so fresh trunks differ between the packages (a
reference tree converts with
:func:`repro_torch.convert.learned_params_from_tree`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .featurize import FEATURE_NAMES, FEATURE_SCHEMA_VERSION

#: trunk activation — SwiGLU, the reference's
ACTIVATION = "silu"
#: the trunk's leaves, (1, d, d_ff) / (1, d_ff, d) stacks of one layer
TRUNK_KEYS = ("wg", "wi", "wo")


@dataclasses.dataclass
class LearnedParams:
    """Trained scorer: weights + input normalisation + schema tag.

    Everything is a numpy-f64 tree (nested dicts of arrays), so the whole
    object travels through session snapshots and
    :mod:`repro_torch.checkpoint` unchanged, under the reference's keys.
    """

    schema: int                      # FEATURE_SCHEMA_VERSION at train time
    mu: np.ndarray                   # (F,) feature means
    sd: np.ndarray                   # (F,) feature stds (>= 1e-9)
    w: dict                          # {"w_lin","b","w_in","trunk","w_out"}
    feature_names: tuple = FEATURE_NAMES

    @property
    def n_features(self) -> int:
        return int(self.mu.shape[0])

    def tree(self) -> dict:
        """Checkpointable pure-array tree (inverse: :meth:`from_tree`)."""
        return {
            "schema": np.int64(self.schema),
            "mu": self.mu,
            "sd": self.sd,
            "w": self.w,
        }

    @classmethod
    def from_tree(cls, tree: dict) -> "LearnedParams":
        w = {k: (dict(v) if isinstance(v, dict) else np.asarray(v, np.float64))
             for k, v in tree["w"].items()}
        if "trunk" in w:
            w["trunk"] = {k: np.asarray(v, np.float64)
                          for k, v in w["trunk"].items()}
        return cls(
            schema=int(tree["schema"]),
            mu=np.asarray(tree["mu"], np.float64),
            sd=np.asarray(tree["sd"], np.float64),
            w=w,
        )


def _dense(gen: torch.Generator, shape: tuple, fan_in: int) -> np.ndarray:
    """Normal f32 draws scaled by 1/sqrt(fan_in), as f64 (the reference's
    ``dense_init``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32)
    x = x * np.float32(1.0 / np.sqrt(max(fan_in, 1)))
    return x.numpy().astype(np.float64)


def init_params(seed: int = 0, d: int = 8, d_ff: int = 16,
                n_features: int | None = None,
                generator: torch.Generator | None = None) -> LearnedParams:
    """Fresh scorer parameters: zero linear part and output head, a trunk
    drawn from ``generator`` (default: a CPU generator seeded with
    ``seed``).  A fresh scorer is exactly its linear part."""
    F = n_features if n_features is not None else len(FEATURE_NAMES)
    gen = generator
    if gen is None:
        gen = torch.Generator().manual_seed(int(seed))
    trunk = {
        "wi": _dense(gen, (1, d, d_ff), d),
        "wo": _dense(gen, (1, d_ff, d), d_ff),
    }
    if ACTIVATION == "silu":                      # SwiGLU gate
        trunk["wg"] = _dense(gen, (1, d, d_ff), d)
    w = {
        "w_lin": np.zeros(F, np.float64),
        "b": np.zeros((), np.float64),
        "w_in": _dense(gen, (F, d), F),
        "trunk": trunk,
        "w_out": np.zeros(d, np.float64),
    }
    return LearnedParams(
        schema=FEATURE_SCHEMA_VERSION,
        mu=np.zeros(F, np.float64),
        sd=np.ones(F, np.float64),
        w=w,
    )


def warm_params(lam: float, mu_price: float, t_cg: float,
                keep_factor: float = 1.0, seed: int = 0, d: int = 8,
                d_ff: int = 16) -> LearnedParams:
    """TTL-equivalent warm start.

    The TTL baseline keeps item i iff ``count_i * lam >= keep_factor * mu
    * t_cg``; with the zeroed MLP head the score

        log1p(count) - log1p(keep_factor * mu * t_cg / lam)

    has the same sign.  Training refines from the baseline.
    """
    p = init_params(seed=seed, d=d, d_ff=d_ff)
    thr = keep_factor * mu_price * t_cg / max(lam, 1e-12)
    p.w["w_lin"][0] = 1.0
    p.w["b"] = np.float64(-np.log1p(thr))
    return p


def _check_schema(params: LearnedParams) -> None:
    if params.schema != FEATURE_SCHEMA_VERSION:
        raise ValueError(
            f"LearnedParams schema {params.schema} != featurizer schema "
            f"{FEATURE_SCHEMA_VERSION}; retrain the scorer")


def _silu_np(x: np.ndarray) -> np.ndarray:
    # branch on sign so exp() never sees a large positive argument
    pos = x >= 0
    e = np.exp(np.where(pos, -x, x))
    return np.where(pos, x / (1.0 + e), x * e / (1.0 + e))


def forward_np(params: LearnedParams, x: np.ndarray) -> np.ndarray:
    """(n, F) features -> (n,) scores; numpy f64, the canonical path."""
    _check_schema(params)
    w = params.w
    z = (np.asarray(x, np.float64) - params.mu) / params.sd
    h = z @ w["w_in"]
    t = w["trunk"]
    g = _silu_np(h @ t["wi"][0])
    if "wg" in t:
        g = g * (h @ t["wg"][0])
    y = g @ t["wo"][0]
    return z @ w["w_lin"] + w["b"] + y @ w["w_out"]


def forward_torch(w: dict, mu, sd, x):
    """The torch twin of :func:`forward_np` over the raw weight tree (a
    dict of tensors), so the trainer can differentiate through it;
    matches the numpy path to f64 round-off."""
    z = (x - mu) / sd
    h = z @ w["w_in"]
    t = {k: v[0] for k, v in w["trunk"].items()}
    g = torch.nn.functional.silu(h @ t["wi"])
    if "wg" in t:
        g = g * (h @ t["wg"])
    y = g @ t["wo"]
    return z @ w["w_lin"] + w["b"] + y @ w["w_out"]


class Scorer(nn.Module):
    """A :class:`LearnedParams` as a module: the weight tree's leaves are
    its parameters under their names (``w_lin``, ``b``, ``w_in``,
    ``trunk.wi``, ``trunk.wg``, ``trunk.wo``, ``w_out``), ``mu`` / ``sd``
    its buffers; :meth:`forward` is :func:`forward_torch`."""

    def __init__(self, params: LearnedParams, device=None,
                 dtype: torch.dtype = torch.float64):
        super().__init__()
        _check_schema(params)
        self.schema = params.schema
        self.feature_names = params.feature_names

        def leaf(a):
            return nn.Parameter(torch.as_tensor(
                np.asarray(a, np.float64), dtype=dtype, device=device))

        w = params.w
        for key in ("w_lin", "b", "w_in", "w_out"):
            self.register_parameter(key, leaf(w[key]))
        self.trunk = nn.ParameterDict(
            {k: leaf(v) for k, v in w["trunk"].items()})
        self.register_buffer("mu", torch.as_tensor(
            params.mu, dtype=dtype, device=device))
        self.register_buffer("sd", torch.as_tensor(
            params.sd, dtype=dtype, device=device))

    def tree(self) -> dict:
        """The weight tree of the module's parameters (the reference's
        ``LearnedParams.w`` layout)."""
        return {"w_lin": self.w_lin, "b": self.b, "w_in": self.w_in,
                "trunk": dict(self.trunk.items()), "w_out": self.w_out}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward_torch(self.tree(), self.mu, self.sd, x)

    def to_params(self) -> LearnedParams:
        """The module's state as a numpy-f64 :class:`LearnedParams`."""
        def host(t):
            return t.detach().cpu().numpy().astype(np.float64)

        w = self.tree()
        return LearnedParams(
            schema=self.schema, mu=host(self.mu), sd=host(self.sd),
            w={**{k: host(v) for k, v in w.items() if k != "trunk"},
               "trunk": {k: host(v) for k, v in w["trunk"].items()}},
            feature_names=tuple(self.feature_names))
