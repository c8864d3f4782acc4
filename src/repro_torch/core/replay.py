"""The device replay: cost hooks, state transfer, engine and offline driver.

The device half of ``repro.core.engine_jax`` as far as the AKPC replay with
on-device clique generation needs it:

* :func:`cost_spec` turns a cost model into per-server arrays plus a static
  kind, and :func:`_transfer_hook` / :func:`_rate_hook` price events from
  them on the device (table1, tiered, heterogeneous);
* :func:`state_to_device` / :func:`apply_acc` move state and cost totals
  between the host :class:`~repro_torch.core.engine.CacheState` /
  :class:`~repro_torch.core.cost.CostBreakdown` and the device carry;
* :class:`TorchReplayEngine` and :func:`run_policy_torch` are the
  counterparts of ``JaxReplayEngine`` and ``run_policy_jax``.

``replay`` routes an AKPC policy to :func:`repro_torch.core.cgm.replay_cgm`.
Everything else (the host-schedule replay scan behind the baselines and
per-server dt) is port slice 2 and raises ``NotImplementedError``.

Entry points take ``device=None``, which means ``"cuda"``: without CUDA
they raise unless the caller asked for ``device="cpu"``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .cost import (
    CacheEnvironment,
    CostBreakdown,
    CostModel,
    HeterogeneousCostModel,
    Table1CostModel,
    TieredCostModel,
)
from .engine import CacheState, ReplayEngine
from .state_layout import StateLayout

#: cost models the device hooks express
DEVICE_COST_MODELS = ("table1", "tiered", "heterogeneous")
#: target deduplicated events per replay step under default slicing
NE_TARGET = 8192
#: device cost accumulator slots: transfer, caching, keepalive rent,
#: misses, hits, items transferred
N_ACC = 6


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda.  Raises when CUDA is asked for but absent: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev


def _bucket(x: int, step: int, floor: int) -> int:
    """Round up to a multiple of ``step`` (>= floor)."""
    return max(floor, -(-x // step) * step)


def cost_spec(model: CostModel, env: CacheEnvironment) -> tuple[dict, tuple]:
    """(spec arrays, static key) reproducing ``model``'s batched hooks.

    ``spec`` is a dict of numpy arrays; the static key
    ``(kind, literal, n_tiers)`` selects the formula.
    """
    p = env.params
    spec = {
        "dt": np.asarray(model.dt(), dtype=np.float64),
        "alpha": np.float64(p.alpha),
        "lam": np.float64(p.lam),
        "mu": np.float64(p.mu),
        "lam_j": env.lam_per_server(),
        "mu_j": env.mu_per_server(),
        "tier_lo": np.zeros(0),
        "tier_hi": np.zeros(0),
        "tier_rates": np.zeros(0),
    }
    literal = p.cost_mode == "paper_literal"
    if isinstance(model, TieredCostModel):
        spec["tier_lo"] = model._lo.astype(np.float64)
        spec["tier_hi"] = model._hi.astype(np.float64)
        spec["tier_rates"] = model.rates.astype(np.float64)
        return spec, ("tiered", literal, int(model.rates.shape[0]))
    if isinstance(model, HeterogeneousCostModel):
        return spec, ("heterogeneous", literal, 0)
    if isinstance(model, Table1CostModel):
        return spec, ("table1", literal, 0)
    raise NotImplementedError(
        f"cost model {model.name!r} has no device formula; the port "
        f"supports {DEVICE_COST_MODELS}")


def spec_to_device(spec: dict, device) -> dict:
    """Scalars stay Python floats (f64 arithmetic on f64 tensors is the
    same as the reference's f64 arrays); arrays go to the device as f64."""
    out = {}
    for k, v in spec.items():
        a = np.asarray(v)
        out[k] = (float(a) if a.ndim == 0 else
                  torch.as_tensor(a, dtype=torch.float64, device=device))
    return out


def _transfer_hook(kind, spec, counts, sizes, j):
    if kind[0] == "table1":
        if kind[1]:  # paper_literal: Alg. 5 line 11 as written
            packed = spec["alpha"] * spec["mu"] * counts
        else:
            packed = (1.0 + (counts - 1.0) * spec["alpha"]) * spec["lam"]
        return torch.where(counts > 1, packed, counts * spec["lam"])
    if kind[0] == "tiered":
        v = sizes[:, None]
        seg = torch.clamp(
            torch.minimum(v, spec["tier_hi"]) - spec["tier_lo"], min=0.0)
        return spec["lam_j"][j] * (seg * spec["tier_rates"]).sum(dim=-1)
    # heterogeneous
    disc = torch.where(
        counts > 1, (1.0 + (counts - 1.0) * spec["alpha"]) / counts, 1.0)
    return spec["lam_j"][j] * sizes * disc


def _rate_hook(kind, spec, counts, sizes, j):
    if kind[0] == "table1":
        return counts * spec["mu"]
    return spec["mu_j"][j] * sizes


def state_to_device(state: CacheState, n: int, device) -> tuple:
    """Host ``CacheState`` -> dense device arrays: ``E`` (n+1, m) float64,
    ``anchor`` (n+1,) int64, the last row being the dump row."""
    rows, cols = StateLayout.resolve(None).state_dims(n, state.m)
    E0 = np.zeros((rows, cols), np.float64)
    a0 = np.full(rows, -1, np.int64)
    k = state.partition.k
    E0[:k] = state.E
    a0[:k] = state.anchor
    return (torch.as_tensor(E0, device=device),
            torch.as_tensor(a0, device=device))


def apply_acc(costs: CostBreakdown, schedule, acc: np.ndarray) -> CostBreakdown:
    """Fold the device accumulator + host counters into ``costs``."""
    costs.transfer += float(acc[0])
    costs.caching += float(acc[1])
    costs.keepalive_rent += float(acc[2])
    costs.n_misses += int(acc[3])
    costs.n_hits += int(acc[4])
    costs.items_transferred += int(acc[5])
    costs.n_requests += schedule.n_requests
    costs.n_item_requests += schedule.n_item_requests
    return costs


class TorchReplayEngine:
    """The device replay driver (counterpart of ``JaxReplayEngine``).

    Wraps (or builds) a :class:`~repro_torch.core.engine.ReplayEngine` that
    holds configuration, cache state and costs; ``replay`` runs the trace
    on ``device`` and syncs state + costs back, so the host state after a
    replay equals what the numpy engine of ``repro`` produces.
    """

    def __init__(self, *args, engine: ReplayEngine | None = None,
                 device=None, layout: StateLayout | str | None = None,
                 **kwargs):
        self.device = resolve_device(device)
        self.layout = StateLayout.resolve(layout)   # dense only
        self.engine = engine if engine is not None else ReplayEngine(
            *args, **kwargs)
        self._spec, self._statics = cost_spec(
            self.engine.model, self.engine.env)
        self.last_schedule = None
        self.last_stats: dict = {}

    @property
    def state(self) -> CacheState:
        return self.engine.state

    @property
    def costs(self) -> CostBreakdown:
        return self.engine.costs

    def install_partition(self, *a, **k) -> None:
        self.engine.install_partition(*a, **k)

    def replay(self, trace, clique_generator=None, t_cg=None,
               batch_size=None, *, next_cg0=None, win_prefix=None,
               use_kernels: bool = True) -> CostBreakdown:
        """Replay ``trace`` with the device clique generation.

        ``clique_generator`` is an AKPC policy's ``on_window``; its policy
        runs on the device and gets its window bookkeeping back.
        ``use_kernels=False`` runs the plain versions in place of the
        kernels on the same device (the comparison run).
        """
        from .cgm import replay_cgm
        from .cgm_schedule import wants_device_cgm

        pol = getattr(clique_generator, "__self__", None)
        if pol is None or t_cg is None:
            raise NotImplementedError(
                "a replay without the AKPC clique generation runs the "
                "host-schedule scan, which is port slice 2")
        if not wants_device_cgm(pol, trace, self.engine.model):
            raise NotImplementedError(
                "this policy, cost model or trace is outside the device "
                "clique generation (per-server dt, a non-AKPC policy, or a "
                "hot set too large); its replay is port slice 2")
        return replay_cgm(
            self, pol, trace, t_cg=t_cg, batch_size=batch_size,
            next_cg0=next_cg0, win_prefix=win_prefix,
            use_kernels=use_kernels)


def run_policy_torch(policy, trace, *, device=None, batch_size=None,
                     use_kernels: bool = True):
    """Offline driver on the device: the counterpart of ``run_policy_jax``.

    Binds the policy, resolves the environment, replays the trace in T_CG
    windows with the clique generation on the device, and returns a
    :class:`~repro_torch.core.policy.RunResult`.
    """
    from .policy import RunResult, get_policy

    if isinstance(policy, str):
        policy = get_policy(policy)
    t0 = time.perf_counter()
    policy.bind(trace.n, trace.m)
    env = CacheEnvironment.resolve(
        getattr(policy, "env", None), trace, policy.params)
    eng = TorchReplayEngine(
        trace.n,
        trace.m,
        policy.params,
        caching_charge=getattr(policy, "caching_charge", "requested"),
        seed_new_cliques=getattr(policy, "seed_new_cliques", True),
        env=env,
        cost_model=getattr(policy, "cost_model", "table1"),
        device=device,
    )
    part0 = policy.initial_partition(trace)
    if part0 is not None:
        eng.install_partition(part0, now=0.0)
    bs = batch_size if batch_size is not None else policy.batch_size
    eng.replay(trace, clique_generator=policy.on_window, t_cg=policy.t_cg,
               batch_size=bs, use_kernels=use_kernels)
    return RunResult(
        policy=policy.name,
        costs=eng.costs,
        clique_sizes=eng.state.partition.sizes(),
        size_history=list(policy.size_history),
        n_windows=policy.n_windows,
        cg_seconds=policy.cg_seconds,
        wall_seconds=time.perf_counter() - t0,
        config=policy.config,
        state=eng.state,
        loop_stats=dict(eng.last_stats),
    )
