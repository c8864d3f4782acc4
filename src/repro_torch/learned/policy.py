"""The ``learned`` keep-or-not CachePolicy: serve the trained scorer.

The port of ``repro.learned.policy``.  Same engine contract as the TTL
baseline (``TTLKeepOrNotPolicy``): no packing — every partition is the
singleton partition — and at each T_CG boundary a per-item keep/evict
mask is recomputed, which the replays realise through the
:meth:`item_keep` hook (the host schedule's boundary evictions, the
numpy engine's ``set_item_keep``).  The window is featurized
(:mod:`featurize`) and scored by the trained model (:mod:`model`): keep
iff score >= 0.

Decisions are computed once, on the host, in numpy float64, exactly as
the reference computes them: every replay (CPU or card; offline, session
or live engine) consumes the identical mask, so cost parity across them
and with the reference is exact.  The torch forward serves the trainer
only.

With no trained parameters the policy serves the TTL-equivalent warm
start (:func:`model.warm_params`) and reproduces the TTL baseline's
decisions exactly.  ``state_dict`` / ``load_state_dict`` use the
reference's keys (``keep``, ``feat``, ``lp``), so a session snapshot with
this policy crosses between the packages.
"""
from __future__ import annotations

import time as _time

import numpy as np

from ..core.cliques import CliquePartition
from ..core.cost import CacheEnvironment, CostModel, CostParams, get_cost_model
from ..core.crm import build_window_crm
from ..core.policy import BasePolicy
from .featurize import (
    features_np,
    init_stats,
    update_stats,
    window_co_degree,
)
from .model import LearnedParams, forward_np, warm_params


class LearnedPolicy(BasePolicy):
    """Keep-or-not policy scored by a trained (or warm-start) model.

    ``learned`` is a :class:`LearnedParams` from ``train_policy`` /
    ``load_learned_params``; ``None`` serves the TTL-equivalent warm
    start built from ``params``/``t_cg``/``keep_factor``.  ``top_frac``
    bounds the window CRM used for the co-access-degree feature (1.0 =
    all window items, the keep-or-not default: no packing means no
    hot-set pruning pressure).
    """

    name = "learned"

    def __init__(
        self,
        params: CostParams | None = None,
        t_cg: float = 50.0,
        learned: LearnedParams | None = None,
        keep_factor: float = 1.0,
        top_frac: float = 1.0,
        caching_charge="requested",
        batch_size: int | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        # bind() (called by super().__init__) reads these
        self.learned = learned
        self.keep_factor = keep_factor
        self.t_cg = t_cg
        self.top_frac = top_frac
        super().__init__(params, env=env, cost_model=cost_model)
        self.caching_charge = caching_charge
        self.batch_size = batch_size

    # -- lifecycle ---------------------------------------------------------
    def bind(self, n: int, m: int) -> None:
        super().bind(n, m)
        self._keep = np.ones(n, dtype=bool)
        p = self.params
        env = self.env
        if env is not None and env.m == m and m > 0:
            self._dt = float(np.max(get_cost_model(self.cost_model, env).dt()))
        else:
            self._dt = p.rho * p.lam / max(p.mu, 1e-12)
        if env is not None and env.n == n:
            self._sizes = env.sizes()
        else:
            self._sizes = np.ones(n, dtype=np.float64)
        self._stats = init_stats(n, self._dt)
        if self.learned is not None:
            self._lp = self.learned
        else:
            self._lp = warm_params(p.lam, p.mu, self.t_cg, self.keep_factor)

    # -- engine hooks ------------------------------------------------------
    def item_keep(self) -> np.ndarray:
        """Engine keep-or-not hook: the current per-item keep mask."""
        return self._keep

    def on_window(self, items, servers, now):
        del servers
        t0 = _time.perf_counter()
        flat = items[items >= 0]
        counts = np.bincount(flat, minlength=self.n).astype(np.float64)
        crm = (build_window_crm(items, self.n, self.params.theta,
                                self.top_frac)
               if flat.size else None)
        co_deg = window_co_degree(crm, self.n)
        update_stats(self._stats, counts, float(now), self.t_cg)
        if self._partition is not None:
            part_prev = self._partition
            csz = part_prev.sizes()[part_prev.clique_of].astype(np.float64)
        else:
            csz = np.ones(self.n, dtype=np.float64)
        X = features_np(counts, co_deg, self._stats, self._sizes, csz,
                        float(now), self._dt, self.t_cg)
        self._keep = forward_np(self._lp, X) >= 0.0
        part = CliquePartition.singletons(self.n)
        self._record(part, _time.perf_counter() - t0)
        return part

    # -- snapshot ----------------------------------------------------------
    def state_dict(self) -> dict:
        d = super().state_dict()
        d["keep"] = self._keep.copy()
        d["feat"] = {k: v.copy() for k, v in self._stats.items()}
        lp = self._lp.tree()
        d["lp"] = {
            "schema": lp["schema"],
            "mu": lp["mu"].copy(),
            "sd": lp["sd"].copy(),
            "w": {
                k: ({kk: vv.copy() for kk, vv in v.items()}
                    if isinstance(v, dict) else np.asarray(v).copy())
                for k, v in lp["w"].items()
            },
        }
        return d

    def load_state_dict(self, state, partition=None) -> None:
        super().load_state_dict(state, partition)
        if "keep" in state:
            self._keep = np.asarray(state["keep"]).astype(bool).copy()
        if "feat" in state:
            self._stats = {
                k: np.asarray(v, np.float64).copy()
                for k, v in state["feat"].items()
            }
        if "lp" in state:
            self._lp = LearnedParams.from_tree(state["lp"])
