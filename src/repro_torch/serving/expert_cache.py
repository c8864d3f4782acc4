"""AKPC-managed MoE expert cache on the card (port of ``repro.serving.expert_cache``).

Items     = routed experts of ONE layer (id = expert index; the manager is
            instantiated per layer, or over flattened (layer, expert) ids).
Requests  = the set of experts a serving host activates for a token batch
            (top-k routing outcome): co-activated experts are the paper's
            co-accessed data items.
Servers   = serving hosts; fetching an expert's weights from a peer host or
            from the parameter store costs transfer; keeping it resident
            costs (HBM) rent.  AKPC packs co-activated experts into cliques
            (<= omega) so a routing miss prefetches the whole group at the
            discounted (1 + (p-1)*alpha)*lam cost, and whole-clique TTL
            extension keeps hot expert groups resident.

Routing outcomes stream through the port's
:class:`~repro_torch.core.session.CacheSession` (``backend="session"``) or
the card-resident :class:`~repro_torch.serving.live.LiveServingEngine`
(``"live"``), on CUDA unless the caller passes ``device="cpu"``.
``snapshot`` / ``restore`` checkpoint the cache state with the manager's
clock and history as a numpy tree under the reference's keys, drained
first, so a snapshot of either backend, and of either package, restores
into the other.  ``packed_tables`` lays the cliques out as a contiguous
packed weight table and a per-expert (clique, slot) map, the layout the
gather :func:`repro_torch.kernels.packed_lookup` reads (one row copy a
clique instead of omega scattered row reads).  ``stats`` prices the same
observation history under ``no_packing`` on the manager's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.baselines import run_no_packing
from ..core.cost import CacheEnvironment, CostParams
from ..core.policy import get_policy
from ..core.session import CacheSession
from ..traces.loader import Trace


@dataclasses.dataclass
class ExpertCacheStats:
    akpc_total: float
    nopack_total: float
    n_observations: int
    cliques: list[tuple[int, ...]]

    @property
    def saving_pct(self) -> float:
        if self.nopack_total <= 0:
            return 0.0
        return 100.0 * (1.0 - self.akpc_total / self.nopack_total)


class ExpertCacheManager:
    """``expert_bytes`` (n_experts,) — per-expert weight-table bytes (e.g.
    ``w.nbytes`` per expert row, which differ across experts under
    quantisation / LoRA deltas).  They become the cache environment's item
    sizes so the size-aware cost models (``cost_model="heterogeneous"`` /
    ``"tiered"``) price a miss by the bytes actually DMA'd and rent by the
    HBM actually held; the default ``table1`` keeps the paper's unit
    accounting."""

    def __init__(self, n_experts: int, n_hosts: int,
                 params: CostParams | None = None, t_cg: float = 32.0,
                 d_max: int = 8,
                 expert_bytes: np.ndarray | None = None,
                 cost_model: str = "table1",
                 backend: str = "session",
                 device=None):
        if backend not in ("session", "live"):
            raise ValueError(f"unknown expert-cache backend {backend!r}")
        self.n_experts = n_experts
        self.n_hosts = n_hosts
        self.params = params or CostParams(alpha=0.6, rho=4.0, omega=5)
        self.t_cg = t_cg
        self.d_max = d_max
        self.cost_model = cost_model
        self.backend = backend
        sizes = None
        if expert_bytes is not None:
            b = np.asarray(expert_bytes, dtype=np.float64)
            if b.shape != (n_experts,):
                raise ValueError(
                    f"expert_bytes must have shape ({n_experts},), "
                    f"got {b.shape}")
            sizes = b / b.mean()          # mean-1 volumes
        self.env = CacheEnvironment(
            n=n_experts, m=n_hosts, params=self.params, item_sizes=sizes)
        policy = get_policy("akpc", params=self.params, t_cg=t_cg,
                            top_frac=1.0, cost_model=cost_model)
        if backend == "live":
            # card-resident streaming session: observe calls buffer into
            # async device chunks; stats() / snapshot() drain so readers
            # always see settled numbers
            from .live import LiveServingEngine

            self.session = LiveServingEngine(
                policy, n_experts, n_hosts, env=self.env, device=device)
        else:
            self.session = CacheSession(
                policy, n_experts, n_hosts, env=self.env, device=device)
        self.device = self.session.device
        self._hist: list[tuple[np.ndarray, int, float]] = []
        self._t = 0.0

    def observe(self, topk_idx: np.ndarray, host: int = 0) -> None:
        """topk_idx (tokens, k): one serving step's routing outcome."""
        self._t += 1.0
        experts = np.unique(topk_idx.reshape(-1))
        # split into <= d_max item requests (paper's request-size bound)
        rows = [
            experts[lo : lo + self.d_max].astype(np.int64)
            for lo in range(0, len(experts), self.d_max)
        ]
        items = np.full((len(rows), self.d_max), -1, np.int32)
        for r, g in enumerate(rows):
            items[r, : len(g)] = g
            self._hist.append((g, host, self._t))
        self.session.feed(
            items,
            np.full(len(rows), host, np.int64),
            np.full(len(rows), self._t, np.float64),
        )

    def _settle(self) -> None:
        """Live backend: flush + block so costs/partition are settled."""
        drain = getattr(self.session, "drain", None)
        if drain is not None:
            drain()

    # -- checkpointing -------------------------------------------------------
    def snapshot(self) -> dict:
        """Session state + the manager's clock/history (a pure-numpy tree,
        :mod:`repro_torch.checkpoint`-compatible).  Drained first, so the
        snapshot restores into either backend."""
        self._settle()
        d = max((len(g) for g, _, _ in self._hist), default=1)
        items = np.full((len(self._hist), d), -1, np.int32)
        hosts = np.empty(len(self._hist), np.int32)
        times = np.empty(len(self._hist), np.float64)
        for i, (g, h, t) in enumerate(self._hist):
            items[i, : len(g)] = g
            hosts[i] = h
            times[i] = t
        return {
            "session": self.session.snapshot(),
            "manager": {
                "t": np.float64(self._t),
                "hist_items": items,
                "hist_hosts": hosts,
                "hist_times": times,
            },
        }

    def restore(self, snap: dict) -> None:
        self.session.restore(snap["session"])
        mgr = snap["manager"]
        self._t = float(mgr["t"])
        items = np.asarray(mgr["hist_items"])
        hosts = np.asarray(mgr["hist_hosts"])
        times = np.asarray(mgr["hist_times"])
        self._hist = [
            (row[row >= 0].astype(np.int64), int(h), float(t))
            for row, h, t in zip(items, hosts, times)
        ]

    # -- introspection -------------------------------------------------------
    def cliques(self) -> list[tuple[int, ...]]:
        self._settle()
        return self.session.partition.canonical()

    def packed_tables(self, expert_weights: np.ndarray):
        """Pack clique members contiguously: (n_cliques, omega, ...) table +
        per-expert (clique_id, slot) map for
        :func:`repro_torch.kernels.packed_lookup`."""
        omega = self.params.omega
        cliques = [c for c in self.cliques()]
        # singletons (and leftovers) get their own rows
        covered = {d for c in cliques for d in c}
        for e in range(self.n_experts):
            if e not in covered:
                cliques.append((e,))
        table = np.zeros((len(cliques), omega) + expert_weights.shape[1:],
                         expert_weights.dtype)
        where = np.zeros((self.n_experts, 2), np.int32)
        for ci, c in enumerate(cliques):
            for slot, e in enumerate(c):
                table[ci, slot] = expert_weights[e]
                where[e] = (ci, slot)
        return table, where

    def stats(self) -> ExpertCacheStats:
        self._settle()
        # replay the same observation history through No-Packing
        if self._hist:
            d_max = max(len(g) for g, _, _ in self._hist)
            items = np.full((len(self._hist), d_max), -1, np.int32)
            servers = np.empty(len(self._hist), np.int32)
            times = np.empty(len(self._hist), np.float64)
            for i, (g, h, t) in enumerate(self._hist):
                items[i, : len(g)] = g
                servers[i] = h
                times[i] = t
            tr = Trace(times=times, servers=servers, items=items,
                       n=self.n_experts, m=self.n_hosts, name="expert-trace")
            # same environment + cost model as the AKPC session, so the
            # saving is apples-to-apples
            nopack = run_no_packing(tr, self.params, env=self.env,
                                    cost_model=self.cost_model,
                                    device=self.device).total
        else:
            nopack = 0.0
        return ExpertCacheStats(
            akpc_total=self.session.costs.total,
            nopack_total=nopack,
            n_observations=len(self._hist),
            cliques=self.cliques(),
        )
