"""Cache-policy layer: policies, registry, result type, offline driver.

The port's counterpart of ``repro.core.policy``: the paper's method set
as registered policies, ``akpc`` (plus the ablations ``akpc_no_acm`` and
``akpc_base``), ``packcache`` (alias ``packcache2``, online 2-packing),
``dp_greedy`` (offline 2-packing), ``ttl`` (keep-or-not TTL),
``no_packing`` and ``learned`` (the trained keep-or-not scorer of
:mod:`repro_torch.learned`, imported when it is first asked for).  A policy's ``on_window(items, servers, now)`` is Alg. 1
Event 1 on the host, called at every T_CG boundary with the previous
window's requests; ``initial_partition(trace)`` is the offline hook.

An AKPC policy whose replay the device clique generation admits never
calls ``on_window``: :func:`repro_torch.core.cgm.replay_cgm` runs the
clique generation on the device and folds the window bookkeeping back
into the policy.  Every other replay calls it from the host schedule
(:func:`repro_torch.core.schedule.build_schedule`).

``state_dict()`` / ``load_state_dict(state, partition=None)`` carry a
policy's mutable state (window counts, size history, the TTL keep mask,
the AKPC previous-window CRM) under ``repro``'s keys and dtypes, so a
session snapshot taken in either package restores into the other.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np

from ..spans import span
from .akpc import AKPCConfig
from .cliques import CliquePartition, generate_cliques
from .cost import CacheEnvironment, CostBreakdown, CostModel, CostParams
from .crm import WindowCRM, build_window_crm
from .engine import CachingCharge


@dataclasses.dataclass
class RunResult:
    """What a policy run returns."""

    policy: str
    costs: CostBreakdown
    clique_sizes: np.ndarray         # sizes of all cliques, final partition
    size_history: list[np.ndarray]   # per-window non-singleton size arrays
    n_windows: int
    cg_seconds: float                # host clique-generation time
    wall_seconds: float              # end-to-end replay wall time
    config: Any = None               # the policy's config object
    state: Any = None                # final host CacheState of the replay
    loop_stats: dict | None = None   # steps, syncs and split of the replay
    shard_stats: dict | None = None  # per-shard totals of a sharded sweep point

    @property
    def total(self) -> float:
        return self.costs.total

    @property
    def transfer(self) -> float:
        return self.costs.transfer

    @property
    def caching(self) -> float:
        return self.costs.caching

    def as_dict(self) -> dict:
        d = self.costs.as_dict()
        d.update(
            policy=self.policy,
            n_windows=self.n_windows,
            cg_seconds=self.cg_seconds,
            wall_seconds=self.wall_seconds,
        )
        return d


@runtime_checkable
class CachePolicy(Protocol):
    """Structural protocol implemented by every registered policy."""

    name: str
    params: CostParams
    t_cg: float | None               # regeneration period; None = never

    def bind(self, n: int, m: int) -> None:
        """Reset per-run state for a catalog of n items and m servers."""
        ...

    def on_window(
        self, items: np.ndarray, servers: np.ndarray, now: float
    ) -> CliquePartition | None:
        """Alg. 1 Event 1: mine the window, return the new partition."""
        ...


class BasePolicy:
    """Shared plumbing: window bookkeeping.

    Subclasses set ``name``/``t_cg`` and implement ``on_window`` (calling
    :meth:`_record` with the produced partition) and, for offline methods,
    :meth:`initial_partition`.
    """

    name = "base"
    t_cg: float | None = None
    caching_charge: CachingCharge = "requested"
    seed_new_cliques: bool = True
    batch_size: int | None = None
    config: Any = None

    def __init__(
        self,
        params: CostParams | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        if params is None:
            params = env.params if env is not None else CostParams()
        self.params = params
        self.env = env                  # None = derive from the trace
        self.cost_model = cost_model
        self.bind(0, 0)

    def bind(self, n: int, m: int) -> None:
        """Reset per-run state for a catalog of n items and m servers."""
        self.n = n
        self.m = m
        self._partition: CliquePartition | None = None
        self.size_history: list[np.ndarray] = []
        self.n_windows = 0
        self.cg_seconds = 0.0

    def initial_partition(self, trace=None) -> CliquePartition | None:
        return None

    def on_window(self, items, servers, now) -> CliquePartition | None:
        return None

    def _record(self, part: CliquePartition, seconds: float) -> None:
        self._partition = part
        self.cg_seconds += seconds
        self.n_windows += 1
        sizes = part.sizes()
        self.size_history.append(sizes[sizes > 1])

    def state_dict(self) -> dict:
        """The policy's mutable state as plain numpy, under the keys and
        dtypes of ``repro``'s policies, so a snapshot of either package
        restores into the other."""
        hist = self.size_history
        return {
            "n_windows": np.int64(self.n_windows),
            "cg_seconds": np.float64(self.cg_seconds),
            "size_hist": (np.concatenate(hist).astype(np.int64)
                          if hist else np.zeros(0, np.int64)),
            "size_hist_lens": np.array([len(a) for a in hist], np.int64),
        }

    def load_state_dict(self, state: dict,
                        partition: CliquePartition | None = None) -> None:
        """Load a :meth:`state_dict`; ``partition`` is the session's
        restored partition, which becomes the policy's current one."""
        self.n_windows = int(state["n_windows"])
        self.cg_seconds = float(state["cg_seconds"])
        flat = np.asarray(state["size_hist"])
        lens = np.asarray(state["size_hist_lens"]).astype(np.int64)
        self.size_history = [
            a.astype(np.int32) for a in np.split(flat, np.cumsum(lens)[:-1])
        ] if lens.size else []
        if partition is not None:
            self._partition = partition


def greedy_pair_matching(
    items: np.ndarray, n: int, theta: float, top_frac: float,
    top_frac_of: str = "window",
) -> CliquePartition:
    """Greedy max-weight matching of items into disjoint pairs.

    Edges come from the binary CRM of ``items`` (Alg. 2), weights from the
    normalised CRM; items left unmatched stay singletons.
    """
    crm = build_window_crm(items, n, theta, top_frac, top_frac_of=top_frac_of)
    w = np.where(crm.binary, crm.norm, 0.0)
    iu, iv = np.nonzero(np.triu(w, k=1))
    order = np.argsort(-w[iu, iv], kind="stable")
    used = np.zeros(crm.n_hot, dtype=bool)
    pairs: list[tuple[int, ...]] = []
    for e in order:
        a, b = int(iu[e]), int(iv[e])
        if used[a] or used[b]:
            continue
        used[a] = used[b] = True
        pairs.append((int(crm.hot_items[a]), int(crm.hot_items[b])))
    return CliquePartition.from_cliques(n, pairs)


class NoPackingPolicy(BasePolicy):
    """Wang et al. [6]-style online TTL caching: no packing component."""

    name = "no_packing"
    t_cg = None

    def __init__(
        self,
        params: CostParams | None = None,
        caching_charge: CachingCharge = "requested",
        batch_size: int | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        super().__init__(params, env=env, cost_model=cost_model)
        self.caching_charge = caching_charge
        self.batch_size = batch_size


class TTLKeepOrNotPolicy(BasePolicy):
    """Keep-or-not TTL baseline (Le Scouarnec et al., arXiv 1312.0499).

    No packing: the partition is always the singleton partition.  At every
    T_CG boundary the previous window's request counts decide, per item,
    whether a cached copy pays for itself over the next window: item i is
    KEPT iff ``count_i * lam >= keep_factor * mu * t_cg``.  Items voted
    "nokeep" are never cached; the replay reads the mask through the
    :meth:`item_keep` hook.  ``on_window`` always returns a partition, so
    that every boundary has an install record to carry the evictions.
    """

    name = "ttl"

    def __init__(
        self,
        params: CostParams | None = None,
        t_cg: float = 50.0,
        keep_factor: float = 1.0,
        caching_charge: CachingCharge = "requested",
        batch_size: int | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        super().__init__(params, env=env, cost_model=cost_model)
        self.t_cg = t_cg
        self.keep_factor = keep_factor
        self.caching_charge = caching_charge
        self.batch_size = batch_size

    def bind(self, n: int, m: int) -> None:
        super().bind(n, m)
        self._keep = np.ones(n, dtype=bool)

    def item_keep(self) -> np.ndarray:
        """Engine keep-or-not hook: the current per-item keep mask."""
        return self._keep

    def on_window(self, items, servers, now):
        del servers, now
        t0 = _time.perf_counter()
        flat = items[items >= 0]
        counts = np.bincount(flat, minlength=self.n).astype(np.float64)
        p = self.params
        self._keep = counts * p.lam >= self.keep_factor * p.mu * self.t_cg
        part = CliquePartition.singletons(self.n)
        self._record(part, _time.perf_counter() - t0)
        return part

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["keep"] = self._keep.copy()
        return d

    def load_state_dict(self, state, partition=None) -> None:
        super().load_state_dict(state, partition)
        if "keep" in state:
            self._keep = np.asarray(state["keep"]).astype(bool).copy()


class PackCache2Policy(BasePolicy):
    """Wu et al. [2]: ONLINE pairwise (2-)packing; FP-tree pair mining
    realised as max-weight greedy matching on the window CRM."""

    name = "packcache"

    def __init__(
        self,
        params: CostParams | None = None,
        t_cg: float = 50.0,
        top_frac: float = 0.1,
        top_frac_of: str = "window",
        caching_charge: CachingCharge = "requested",
        batch_size: int | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        super().__init__(params, env=env, cost_model=cost_model)
        self.t_cg = t_cg
        self.top_frac = top_frac
        self.top_frac_of = top_frac_of
        self.caching_charge = caching_charge
        self.batch_size = batch_size

    def on_window(self, items, servers, now):
        del servers, now
        t0 = _time.perf_counter()
        part = greedy_pair_matching(items, self.n, self.params.theta,
                                    self.top_frac, self.top_frac_of)
        self._record(part, _time.perf_counter() - t0)
        return part


class DPGreedyPolicy(BasePolicy):
    """Huang et al. [4]: OFFLINE pairwise packing.  Pairs are matched on the
    CRM of the FULL trace and kept fixed; pass ``partition`` to use a
    precomputed one instead."""

    name = "dp_greedy"
    t_cg = None

    def __init__(
        self,
        params: CostParams | None = None,
        top_frac: float = 0.1,
        top_frac_of: str = "window",
        partition: CliquePartition | None = None,
        caching_charge: CachingCharge = "requested",
        batch_size: int | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        self._user_partition = partition
        super().__init__(params, env=env, cost_model=cost_model)
        self.top_frac = top_frac
        self.top_frac_of = top_frac_of
        self.caching_charge = caching_charge
        self.batch_size = batch_size

    def bind(self, n: int, m: int) -> None:
        super().bind(n, m)
        self._fixed = self._user_partition

    def initial_partition(self, trace=None) -> CliquePartition | None:
        t0 = _time.perf_counter()
        if self._fixed is None:
            if trace is None:
                raise ValueError(
                    "dp_greedy is offline: construct it with a precomputed "
                    "`partition` or give the driver a full trace")
            self._fixed = greedy_pair_matching(
                trace.items, trace.n, self.params.theta, self.top_frac,
                self.top_frac_of,
            )
        self._record(self._fixed, _time.perf_counter() - t0)
        return self._fixed


class AKPCPolicy(BasePolicy):
    """Adaptive K-PackCache (the paper's proposed online algorithm, Alg. 1).

    The three ablation variants of Fig. 5/7/9 are registered separately:
    ``akpc`` (split + approximate merge), ``akpc_no_acm`` (split only) and
    ``akpc_base`` (neither; omega unused).
    """

    name = "akpc"

    def __init__(
        self,
        config: AKPCConfig | None = None,
        *,
        params: CostParams | None = None,
        t_cg: float | None = None,
        top_frac: float | None = None,
        top_frac_of: str | None = None,
        split: bool | None = None,
        approx_merge: bool | None = None,
        caching_charge: CachingCharge | None = None,
        seed_new_cliques: bool | None = None,
        batch_size: int | None = None,
        crm_matmul: Callable | None = None,
        pair_edges: Callable | None = None,
        kernels: str | None = None,
        name: str | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        cfg = config or AKPCConfig()
        if params is None and env is not None:
            if cfg.params == CostParams():
                params = env.params
            elif cfg.params != env.params:
                raise ValueError(
                    "config.params and env.params disagree; build the "
                    "environment with the config's CostParams (or pass "
                    "params= explicitly)")
        over = {
            "params": params,
            "t_cg": t_cg,
            "top_frac": top_frac,
            "top_frac_of": top_frac_of,
            "enable_split": split,
            "enable_approx_merge": approx_merge,
            "caching_charge": caching_charge,
            "seed_new_cliques": seed_new_cliques,
            "batch_size": batch_size,
            "crm_matmul": crm_matmul,
            "pair_edges": pair_edges,
            "kernels": kernels,
        }
        cfg = dataclasses.replace(
            cfg, **{k: v for k, v in over.items() if v is not None}
        )
        self.config = cfg
        if name is not None:
            self.name = name
        super().__init__(cfg.params, env=env, cost_model=cost_model)
        self.t_cg = cfg.t_cg
        self.caching_charge = cfg.caching_charge
        self.seed_new_cliques = cfg.seed_new_cliques
        self.batch_size = cfg.batch_size

    def bind(self, n: int, m: int) -> None:
        super().bind(n, m)
        self._prev_crm: WindowCRM | None = None
        self._crm_matmul = self.config.crm_matmul
        self._pair_edges = self.config.pair_edges

    def wire_kernels(self, device, use_kernels: bool = True) -> None:
        """Wire the host clique generation's hooks for a replay on
        ``device``: explicit config hooks win; ``kernels="auto"`` takes the
        CUDA kernels (or, with ``use_kernels=False``, their plain versions
        on the card) when ``device`` is CUDA, and the numpy paths on the
        CPU."""
        from ..kernels.autowire import default_cgm_hooks

        cfg = self.config
        mm, pe = cfg.crm_matmul, cfg.pair_edges
        if cfg.kernels == "auto" and (mm is None or pe is None):
            auto_mm, auto_pe = default_cgm_hooks(device, use_kernels)
            mm = mm if mm is not None else auto_mm
            pe = pe if pe is not None else auto_pe
        self._crm_matmul, self._pair_edges = mm, pe

    def on_window(self, items, servers, now):
        """Alg. 1 Event 1 on the host: Alg. 2, then Algs. 4 and 3."""
        del servers, now
        cfg = self.config
        t0 = _time.perf_counter()
        with span("host_cgm.window_crm"):
            crm = build_window_crm(
                items, self.n, cfg.params.theta, cfg.top_frac,
                crm_matmul=self._crm_matmul,
                top_frac_of=cfg.top_frac_of,
            )
        omega = cfg.params.omega if cfg.enable_split else self.n
        with span("host_cgm.cliques"):
            part = generate_cliques(
                self._partition,
                self._prev_crm,
                crm,
                self.n,
                omega,
                cfg.params.gamma,
                pair_edges=self._pair_edges,
                enable_split=cfg.enable_split,
                enable_approx_merge=cfg.enable_approx_merge,
            )
        self._prev_crm = crm
        self._record(part, _time.perf_counter() - t0)
        return part

    def state_dict(self) -> dict:
        """The base state plus the previous window's CRM (``crm``)."""
        d = super().state_dict()
        crm = self._prev_crm
        if crm is None:
            d["crm"] = {
                "present": np.int64(0),
                "hot_items": np.zeros(0, np.int32),
                "raw": np.zeros((0, 0), np.int64),
                "norm": np.zeros((0, 0), np.float32),
                "binary": np.zeros((0, 0), bool),
            }
        else:
            d["crm"] = {
                "present": np.int64(1),
                "hot_items": crm.hot_items.copy(),
                "raw": crm.raw.copy(),
                "norm": crm.norm.copy(),
                "binary": crm.binary.copy(),
            }
        return d

    def load_state_dict(self, state, partition=None) -> None:
        super().load_state_dict(state, partition)
        c = state["crm"]
        if int(c["present"]):
            self._prev_crm = WindowCRM(
                hot_items=np.asarray(c["hot_items"]).astype(np.int32),
                raw=np.asarray(c["raw"]).astype(np.int64),
                norm=np.asarray(c["norm"]).astype(np.float32),
                binary=np.asarray(c["binary"]).astype(bool),
            )
        else:
            self._prev_crm = None


_REGISTRY: dict[str, Callable[..., BasePolicy]] = {
    "no_packing": NoPackingPolicy,
    "ttl": TTLKeepOrNotPolicy,
    "packcache": PackCache2Policy,
    "packcache2": PackCache2Policy,
    "dp_greedy": DPGreedyPolicy,
    "akpc": AKPCPolicy,
    "akpc_no_acm": lambda **kw: AKPCPolicy(
        **{"split": True, "approx_merge": False, "name": "akpc_no_acm", **kw}),
    "akpc_base": lambda **kw: AKPCPolicy(
        **{"split": False, "approx_merge": False, "name": "akpc_base", **kw}),
}


def _learned_factory(**kw):
    # deferred: repro_torch.learned.policy imports this module
    from ..learned.policy import LearnedPolicy

    return LearnedPolicy(**kw)


_REGISTRY["learned"] = _learned_factory


def register_policy(name: str, *aliases: str):
    """Register a policy factory under ``name`` and ``aliases`` (usable as
    a class decorator); a name already taken raises."""

    def deco(factory):
        for nm in (name, *aliases):
            if nm in _REGISTRY:
                raise ValueError(f"policy {nm!r} already registered")
            _REGISTRY[nm] = factory
        return factory

    return deco


def get_policy(name: str, **kwargs) -> BasePolicy:
    """Instantiate a registered policy by name (fresh state every call)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return factory(**kwargs)


def list_policies() -> list[str]:
    """The registered policy names (aliases included), sorted."""
    return sorted(_REGISTRY)


def run_policy(
    policy: BasePolicy | str,
    trace,
    *,
    device=None,
    batch_size: int | None = None,
    progress: Callable[[int], None] | None = None,
    layout=None,
) -> RunResult:
    """Replay a full trace under ``policy`` on ``device`` (default CUDA).

    The counterpart of ``repro.core.run_policy(..., backend="jax")``: same
    :class:`RunResult`, state float-for-float equal to the numpy engine,
    costs equal at 1e-9.  ``device=None`` means ``"cuda"`` and raises when
    CUDA is absent; pass ``device="cpu"`` to run the plain versions on the
    CPU.  ``layout`` is the device state layout
    (:class:`~repro_torch.core.state_layout.StateLayout`; dense, bucketed
    or row_sharded).
    """
    from .replay import run_policy_torch

    return run_policy_torch(
        policy, trace, device=device, batch_size=batch_size,
        progress=progress, layout=layout)
