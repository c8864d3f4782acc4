"""Frozen copy of ``src/repro/core/cost.py`` at commit 63887c5 (numpy only).

Part of the benchmark's plain reference: it imports nothing of the
measured package, so a later change to the program cannot move it.

Changes from the copied file: the ``tiered`` model and the competitive
bounds are left out (the benchmark prices ``table1`` and
``heterogeneous``).


Cost layer of the K-PackCache problem (paper §III.C, Table I, eqs. 1-5).

Two cost components paid by the CDN operator:

* transfer cost  C_T : paid to the network provider per transfer event.
    unpacked  p items : p * lambda
    packed    p items : (1 + (p-1) * alpha) * lambda          (Table I)
* caching  cost  C_P : storage rental, ``items * mu`` per unit time; every
  access extends the expiry of the cached unit to ``t + dt`` where
  ``dt = rho * lambda / mu``  (Alg. 6 line 1).

``alpha in [0, 1]`` is the packing discount: for alpha < 1 packed transfer is
always cheaper than individual transfers.

The paper's pseudocode (Alg. 5 line 11) literally charges ``alpha*mu*|c|`` for
a packed transfer, which is inconsistent with its own Table I and with the
competitive proof (both use ``(1+(|c|-1)*alpha)*lambda``).  We default to the
Table-I form (``cost_mode="consistent"``) and keep the literal pseudocode form
available (``cost_mode="paper_literal"``) for reproduction of the raw
pseudocode.  See DESIGN.md §2.

Pluggable cost models (PR 4, DESIGN.md §9)
------------------------------------------

Table I is only ONE pricing regime — a single homogeneous scalar
``(lam, mu)`` over unit-size items.  This module generalises the cost layer
into a registry of **vectorized** :class:`CostModel` implementations bound to
a :class:`CacheEnvironment` (per-server prices ``lam_j``/``mu_j``, per-item
sizes ``s_i``):

* ``table1``        the paper's model, bit-identical to the historical
                    scalar ``CostParams`` path (the default everywhere);
* ``heterogeneous`` per-server prices + size-weighted transfer/rent
                    (Qin & Etesami-style files-with-sizes over distributed
                    heterogeneous caches); ``dt_j = rho*lam_j/mu_j`` varies
                    per server, which the replay engine handles with a
                    segment-max anchor scan (engine.py, DESIGN.md §9).

Every model exposes three batched hooks consumed by the replay engine:
``transfer_cost_batch(counts, sizes, servers) -> (E,)`` per-event transfer
cost of a whole-clique fetch, ``caching_rate(counts, sizes, servers) -> (E,)``
rent per unit time, and ``dt() -> (m,)`` the per-server TTL extension.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Literal

import numpy as np

CostMode = Literal["consistent", "paper_literal"]


@dataclasses.dataclass(frozen=True)
class CostParams:
    """All scalar knobs of the cost model + AKPC hyper-parameters (Table II)."""

    lam: float = 1.0          # base transfer cost (lambda)
    mu: float = 1.0           # caching cost per item per unit time
    rho: float = 1.0          # cost ratio; dt = rho * lam / mu
    alpha: float = 0.8        # packing discount factor  (Table II: 0.8)
    omega: int = 5            # max (and target) clique size  (Table II: 5)
    theta: float = 0.2        # CRM binarisation threshold  (Table II: 0.2)
    gamma: float = 0.85       # approximate-merge density threshold (Table II)
    cost_mode: CostMode = "consistent"

    @property
    def dt(self) -> float:
        """Cache lifetime extension Delta-t = rho * lambda / mu (Alg. 6)."""
        return self.rho * self.lam / self.mu

    def transfer_cost(self, p: int, *, packed: bool) -> float:
        """Transfer cost of moving ``p`` items in one event (Table I)."""
        if p <= 0:
            return 0.0
        if not packed or p == 1:
            return p * self.lam
        if self.cost_mode == "paper_literal":
            # Alg. 5 line 11 (literal):  C_T += alpha * mu * |c|
            return self.alpha * self.mu * p
        return (1.0 + (p - 1) * self.alpha) * self.lam

    def caching_cost(self, n_items: int, duration: float) -> float:
        """Rental cost of keeping ``n_items`` cached for ``duration`` time."""
        if duration <= 0.0 or n_items <= 0:
            return 0.0
        return n_items * self.mu * duration


# ---------------------------------------------------------------------------
# environment: WHO pays WHAT — servers, prices, item sizes
# ---------------------------------------------------------------------------
def _as_price_array(x, m: int, what: str) -> np.ndarray | None:
    if x is None:
        return None
    a = np.asarray(x, dtype=np.float64)
    if a.shape != (m,):
        raise ValueError(f"{what} must have shape ({m},), got {a.shape}")
    if not np.all(np.isfinite(a)) or (a <= 0).any():
        raise ValueError(f"{what} must be finite and positive")
    return a


@dataclasses.dataclass(frozen=True, eq=False)
class CacheEnvironment:
    """The scenario a cost model prices: catalog, servers, prices, sizes.

    ``lam_j``/``mu_j`` are per-server (ESS) transfer/storage prices,
    ``item_sizes`` per-item volumes; any of them left ``None`` falls back to
    the homogeneous scalar defaults in ``params`` (unit sizes).  The paper's
    Table-II setup is ``CacheEnvironment(n, m, params)`` with everything
    defaulted.
    """

    n: int                      # catalog size |U|
    m: int                      # number of servers |S|
    params: CostParams = dataclasses.field(default_factory=CostParams)
    lam_j: np.ndarray | None = None     # (m,) per-server transfer price
    mu_j: np.ndarray | None = None      # (m,) per-server storage price
    item_sizes: np.ndarray | None = None  # (n,) per-item sizes (None = unit)

    def __post_init__(self):
        if self.n < 0 or self.m < 0:
            raise ValueError(f"n/m must be >= 0, got n={self.n} m={self.m}")
        object.__setattr__(
            self, "lam_j", _as_price_array(self.lam_j, self.m, "lam_j"))
        object.__setattr__(
            self, "mu_j", _as_price_array(self.mu_j, self.m, "mu_j"))
        if self.item_sizes is not None:
            s = np.asarray(self.item_sizes, dtype=np.float64)
            if s.shape != (self.n,):
                raise ValueError(
                    f"item_sizes must have shape ({self.n},), got {s.shape}")
            if not np.all(np.isfinite(s)) or (s <= 0).any():
                raise ValueError("item_sizes must be finite and positive")
            object.__setattr__(self, "item_sizes", s)

    # -- filled views -------------------------------------------------------
    @property
    def homogeneous(self) -> bool:
        """True iff this is the paper's single-price unit-size scenario."""
        return self.lam_j is None and self.mu_j is None and self.item_sizes is None

    def lam_per_server(self) -> np.ndarray:
        if self.lam_j is not None:
            return self.lam_j
        return np.full(self.m, self.params.lam, dtype=np.float64)

    def mu_per_server(self) -> np.ndarray:
        if self.mu_j is not None:
            return self.mu_j
        return np.full(self.m, self.params.mu, dtype=np.float64)

    def sizes(self) -> np.ndarray:
        if self.item_sizes is not None:
            return self.item_sizes
        return np.ones(self.n, dtype=np.float64)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_trace(cls, trace, params: CostParams | None = None,
                   lam_j=None, mu_j=None) -> "CacheEnvironment":
        """Environment for a trace; picks up ``trace.sizes`` when present."""
        return cls(
            n=trace.n, m=trace.m, params=params or CostParams(),
            lam_j=lam_j, mu_j=mu_j,
            item_sizes=getattr(trace, "sizes", None),
        )

    @classmethod
    def resolve(cls, env: "CacheEnvironment | None", trace,
                params: CostParams | None = None) -> "CacheEnvironment":
        """The environment a driver should price ``trace`` under — THE one
        place encoding the rule every driver shares: no env -> build one
        from the trace; a price-only env + sized trace -> thread the
        trace's sizes in; an env with EXPLICIT sizes wins over the
        trace's."""
        if env is None:
            return cls.from_trace(trace, params)
        sizes = getattr(trace, "sizes", None)
        if env.item_sizes is None and sizes is not None:
            return dataclasses.replace(env, item_sizes=sizes)
        return env

    @classmethod
    def skewed(cls, n: int, m: int, params: CostParams | None = None,
               price_sigma: float = 0.5, size_sigma: float = 0.0,
               seed: int = 0) -> "CacheEnvironment":
        """Synthetic heterogeneous scenario: lognormal per-server prices
        around the scalar defaults (mean-preserving, sigma ``price_sigma``)
        and lognormal item sizes (mean 1, sigma ``size_sigma``).

        Each field draws from its OWN derived rng, so at a fixed seed the
        scenario axes are independent: sweeping ``price_sigma`` never moves
        the item sizes and vice versa (same pattern as the synthetic
        traces' size stream)."""
        params = params or CostParams()

        def logn(mean, sigma, size, key):
            if sigma <= 0.0:
                return None
            rng = np.random.default_rng((seed, key))
            return mean * np.exp(rng.normal(-0.5 * sigma**2, sigma, size))

        return cls(
            n=n, m=m, params=params,
            lam_j=logn(params.lam, price_sigma, m, 1),
            mu_j=logn(params.mu, price_sigma, m, 2),
            item_sizes=logn(1.0, size_sigma, n, 3),
        )


# ---------------------------------------------------------------------------
# the CostModel protocol + registry (mirrors the PR-2 CachePolicy registry)
# ---------------------------------------------------------------------------
class CostModel:
    """Base class of every registered cost model.

    A model is CONFIG (constructor kwargs) + a bound environment
    (:meth:`bind`).  The replay engine consumes the three batched hooks;
    benchmarks/tests use the scalar conveniences, which are generic wrappers
    over the batched hooks (so "batch of one == scalar path" holds by
    construction unless a subclass overrides them).

    Event conventions (matching the engine): each event is ONE transfer /
    rent charge of a group of items at one server — ``counts`` (E,) int item
    multiplicities, ``sizes`` (E,) float total volumes, ``servers`` (E,) int
    server ids.  An event with ``counts > 1`` is a packed (clique) transfer.
    """

    name = "base"
    #: models that ignore sizes let the engine skip per-event size reductions
    uses_sizes = False

    def __init__(self, env: CacheEnvironment | None = None):
        self._env: CacheEnvironment | None = None
        if env is not None:
            self.bind(env)

    # -- binding ------------------------------------------------------------
    def bind(self, env: CacheEnvironment) -> "CostModel":
        """(Re)bind to an environment; returns self.  Idempotent."""
        self._env = env
        self._rebind()
        return self

    def _rebind(self) -> None:
        """Hook for subclasses to precompute bound arrays."""

    def _check_bound(self) -> None:
        if self._env is None:
            raise RuntimeError(f"cost model {self.name!r} is not bound to an "
                               "environment (call .bind(env) first)")

    @property
    def env(self) -> CacheEnvironment:
        self._check_bound()
        return self._env

    @property
    def params(self) -> CostParams:
        return self.env.params

    # -- batched hooks (the engine's hot path) ------------------------------
    def dt(self) -> np.ndarray:
        """(m,) per-server cache-lifetime extension Delta-t_j (Alg. 6)."""
        raise NotImplementedError

    def transfer_cost_batch(
        self, counts: np.ndarray, sizes: np.ndarray, servers: np.ndarray
    ) -> np.ndarray:
        """(E,) cost of transferring each event's group in ONE event."""
        raise NotImplementedError

    def caching_rate(
        self, counts: np.ndarray, sizes: np.ndarray, servers: np.ndarray
    ) -> np.ndarray:
        """(E,) storage rent per unit time of each event's charged group."""
        raise NotImplementedError

    def config_array(self) -> np.ndarray:
        """Float fingerprint of model-specific config (tier schedules, ...)
        beyond the environment — snapshots store it so a restore under a
        differently-configured model of the same name is refused."""
        return np.zeros(0)

    # -- scalar conveniences (benchmarks / property tests) ------------------
    def transfer_cost(self, p: int, *, packed: bool, sizes=None,
                      server: int = 0) -> float:
        """Transfer cost of ``p`` items: one packed event vs p singles.

        ``sizes``: optional per-item sizes (p,); defaults to unit sizes.
        """
        if p <= 0:
            return 0.0
        s = np.ones(p) if sizes is None else np.asarray(sizes, np.float64)
        if s.shape != (p,):
            raise ValueError(f"sizes must have shape ({p},), got {s.shape}")
        if packed:
            return float(self.transfer_cost_batch(
                np.array([p], dtype=np.int64),
                np.array([float(s.sum())]),
                np.array([server], dtype=np.int64))[0])
        return float(self.transfer_cost_batch(
            np.ones(p, dtype=np.int64), s,
            np.full(p, server, dtype=np.int64)).sum())

    def caching_cost(self, n_items: int, duration: float, sizes=None,
                     server: int = 0) -> float:
        """Rent of keeping ``n_items`` cached for ``duration`` time."""
        if duration <= 0.0 or n_items <= 0:
            return 0.0
        s = float(n_items) if sizes is None else float(np.asarray(sizes).sum())
        rate = self.caching_rate(
            np.array([n_items], dtype=np.int64), np.array([s]),
            np.array([server], dtype=np.int64))[0]
        return float(rate * duration)


_COST_MODELS: dict[str, type] = {}


def register_cost_model(name: str, *aliases: str):
    """Register a cost-model class (usable as a class decorator)."""

    def deco(cls):
        for nm in (name, *aliases):
            if nm in _COST_MODELS:
                raise ValueError(f"cost model {nm!r} already registered")
            _COST_MODELS[nm] = cls
        return cls

    return deco


def get_cost_model(
    model: "str | CostModel", env: CacheEnvironment | None = None, **kwargs
) -> CostModel:
    """Resolve a cost model by name (or pass an instance through), binding it
    to ``env`` when given.  Fresh instance every call for names; an instance
    already bound to a DIFFERENT environment is shallow-copied before
    rebinding, so one instance shared across engines never has its pricing
    arrays repointed under an earlier engine's feet."""
    if isinstance(model, CostModel):
        if env is None or model._env is env:
            return model
        if model._env is not None:
            model = copy.copy(model)
        return model.bind(env)
    try:
        cls = _COST_MODELS[model]
    except KeyError:
        raise KeyError(
            f"unknown cost model {model!r}; registered: {sorted(_COST_MODELS)}"
        ) from None
    return cls(env=env, **kwargs)


def list_cost_models() -> list[str]:
    return sorted(_COST_MODELS)


# ---------------------------------------------------------------------------
# shipped models
# ---------------------------------------------------------------------------
@register_cost_model("table1")
class Table1CostModel(CostModel):
    """The paper's Table-I model — BIT-IDENTICAL to the historical scalar
    ``CostParams`` path (same float ops in the same order; see DESIGN.md §9).

    Ignores per-server prices and item sizes: one ``lam``/``mu``, unit items,
    constant ``dt = rho*lam/mu``.
    """

    name = "table1"
    uses_sizes = False

    def dt(self) -> np.ndarray:
        return np.full(self.env.m, self.params.dt, dtype=np.float64)

    def transfer_cost_batch(self, counts, sizes, servers) -> np.ndarray:
        p = self.params
        if p.cost_mode == "paper_literal":
            packed = p.alpha * p.mu * counts
        else:
            packed = (1.0 + (counts - 1) * p.alpha) * p.lam
        return np.where(counts > 1, packed, counts * p.lam)

    def caching_rate(self, counts, sizes, servers) -> np.ndarray:
        return counts * self.params.mu

    # scalar conveniences delegate to the EXACT pre-PR CostParams formulas
    # (the generic base helpers would sum p singleton events, which differs
    # from ``p * lam`` in the last ulp)
    def transfer_cost(self, p, *, packed, sizes=None, server=0) -> float:
        return self.params.transfer_cost(p, packed=packed)

    def caching_cost(self, n_items, duration, sizes=None, server=0) -> float:
        return self.params.caching_cost(n_items, duration)


@register_cost_model("heterogeneous")
class HeterogeneousCostModel(CostModel):
    """Per-server prices + size-weighted costs (files with sizes over
    distributed heterogeneous caches, Qin & Etesami-style).

    * transfer: one event of p items, total volume v, at server j costs
      ``lam_j * v`` unpacked (p == 1) and ``lam_j * v * (1+(p-1)*alpha)/p``
      packed — the Table-I count discount applied to the size-weighted
      volume (reduces to Table I exactly at unit sizes);
    * rent: ``mu_j * volume`` per unit time;
    * ``dt_j = rho * lam_j / mu_j`` — PER SERVER, which is what forces the
      engine's segment-max anchor resolution (DESIGN.md §9).
    """

    name = "heterogeneous"
    uses_sizes = True

    def _rebind(self) -> None:
        self._lam = self.env.lam_per_server()
        self._mu = self.env.mu_per_server()

    def dt(self) -> np.ndarray:
        p = self.params
        return p.rho * self._lam / self._mu

    def transfer_cost_batch(self, counts, sizes, servers) -> np.ndarray:
        p = self.params
        discount = np.where(
            counts > 1, (1.0 + (counts - 1) * p.alpha) / counts, 1.0)
        return self._lam[servers] * sizes * discount

    def caching_rate(self, counts, sizes, servers) -> np.ndarray:
        self._check_bound()
        return self._mu[servers] * sizes


# ---------------------------------------------------------------------------
# cost accumulator
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CostBreakdown:
    """Mutable cost accumulator shared by every engine/baseline.

    ``model`` tags which cost model produced the numbers; :meth:`merge`
    refuses to mix breakdowns priced under different models (the sums would
    be meaningless).
    """

    transfer: float = 0.0         # C_T
    caching: float = 0.0          # C_P
    keepalive_rent: float = 0.0   # hypothetical rent of Alg.6 last-copy
    n_requests: int = 0
    n_item_requests: int = 0      # sum |D_i|
    n_misses: int = 0             # clique-transfer events
    n_hits: int = 0
    items_transferred: int = 0    # includes unrequested clique members
    model: str = "table1"         # cost model that produced these numbers

    @property
    def total(self) -> float:
        return self.transfer + self.caching

    def merge(self, other: "CostBreakdown") -> "CostBreakdown":
        if self.model != other.model:
            raise ValueError(
                f"cannot merge cost breakdowns from different cost models: "
                f"{self.model!r} vs {other.model!r}")
        for f in dataclasses.fields(self):
            if f.name == "model":
                continue
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total"] = self.total
        return d
