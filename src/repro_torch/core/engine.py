"""Cache state, costs and environment of one replay (paper Alg. 1, 5, 6).

The host half of ``repro.core.engine``: the dense per-(clique, server)
:class:`CacheState`, and :class:`ReplayEngine`, the holder of state, cost
model, environment and running :class:`CostBreakdown` that
:class:`repro_torch.core.replay.TorchReplayEngine` wraps.  The replay
itself (Alg. 5/6 per request batch, Alg. 2-4 per T_CG boundary) runs on
the device in :mod:`repro_torch.core.cgm`; this module only translates
state onto an initial partition and keeps the per-clique size caches.

State per clique c and edge storage server j:

* ``E[c, j]``  nominal expiry of the packed copy of c at j (0 = never cached)
* ``anchor[c]`` the server whose copy Alg. 6 keeps alive (the argmax of
  the row's expiries, -1 if the clique was never cached).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from .cliques import CliquePartition
from .cost import (
    CacheEnvironment,
    CostBreakdown,
    CostModel,
    CostParams,
    get_cost_model,
)

CachingCharge = Literal["requested", "stored"]

#: default time-slice size for batched replay (requests per batch)
DEFAULT_BATCH_SIZE = 4096


@dataclasses.dataclass
class CacheState:
    """Dense per-(clique, server) cache bookkeeping (host numpy)."""

    partition: CliquePartition
    E: np.ndarray               # (k, m) float64 nominal expiries
    anchor: np.ndarray          # (k,) int32, -1 if clique never cached
    m: int

    @classmethod
    def fresh(cls, partition: CliquePartition, m: int) -> "CacheState":
        k = partition.k
        return cls(
            partition=partition,
            E=np.zeros((k, m), dtype=np.float64),
            anchor=np.full(k, -1, dtype=np.int32),
            m=m,
        )


def match_partitions(
    old_partition: CliquePartition, new_partition: CliquePartition
) -> tuple[np.ndarray, np.ndarray]:
    """(matched, cand): which new cliques equal an old clique, and which.

    A new clique equals an old one iff all its members map to one old
    clique of the same size.
    """
    k = new_partition.k
    new_sizes = new_partition.sizes().astype(np.int64)
    old_sizes = old_partition.sizes().astype(np.int64)
    old_of = old_partition.clique_of
    packed = new_partition.packed()                  # (k, w) -1 padded
    if k == 0:
        return np.zeros(0, bool), np.zeros(0, np.int64)
    cand = old_of[packed[:, 0]].astype(np.int64)     # old clique of 1st member
    same = (old_of[np.maximum(packed, 0)] == cand[:, None]) | (packed < 0)
    matched = same.all(axis=1) & (old_sizes[cand] == new_sizes)
    return matched, cand


def window_seed_servers(
    n: int,
    m: int,
    partition: CliquePartition,
    window_items: np.ndarray,
    window_servers: np.ndarray,
) -> np.ndarray:
    """(k,) the server that accessed each clique's members most during the
    window (Alg. 1 line 5 seeding target)."""
    order = partition.member_order()
    sizes = partition.sizes().astype(np.int64)
    starts = np.zeros(partition.k, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    seed_counts = np.zeros((n, m), dtype=np.int64)
    reps = (window_items >= 0).sum(axis=1)
    srv = np.repeat(window_servers, reps)
    itm = window_items[window_items >= 0]
    np.add.at(seed_counts, (itm, srv), 1)
    seed_sum = np.add.reduceat(seed_counts[order], starts, axis=0)
    return np.argmax(seed_sum, axis=1)


class ReplayEngine:
    """State, cost model, environment and costs of one replay.

    The counterpart of the object ``repro``'s ``JaxReplayEngine`` wraps:
    configuration, the host :class:`CacheState` between replays, the
    per-clique size caches and the running :class:`CostBreakdown`.  The
    replay runs in :class:`repro_torch.core.replay.TorchReplayEngine`.
    """

    def __init__(
        self,
        n: int,
        m: int,
        params: CostParams | None = None,
        caching_charge: CachingCharge = "requested",
        seed_new_cliques: bool = True,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
    ):
        self.n = n
        self.m = m
        if env is None:
            env = CacheEnvironment(n=n, m=m, params=params or CostParams())
        elif (env.n, env.m) != (n, m):
            raise ValueError(
                f"environment shape ({env.n}, {env.m}) != engine ({n}, {m})")
        elif params is not None and params != env.params:
            raise ValueError(
                "params and env.params disagree; build the environment with "
                "the same CostParams you pass to the engine/policy")
        self.env = env
        self.params = params if params is not None else env.params
        self.model = get_cost_model(cost_model, env)
        self._dt_arr = np.asarray(self.model.dt(), dtype=np.float64)
        self._item_sizes = env.sizes() if self.model.uses_sizes else None
        self.caching_charge = caching_charge
        self.seed_new_cliques = seed_new_cliques
        self.state = CacheState.fresh(CliquePartition.singletons(n), m)
        self._set_partition_caches(self.state.partition)
        self.costs = CostBreakdown(model=self.model.name)

    def _set_partition_caches(self, partition: CliquePartition) -> None:
        """Per-clique member counts + (for size-aware models) total volumes."""
        self._sizes = partition.sizes().astype(np.int64)
        if self._item_sizes is None or partition.k == 0:
            self._csizes = None
        else:
            order = partition.member_order()
            starts = np.zeros(partition.k, np.int64)
            np.cumsum(self._sizes[:-1], out=starts[1:])
            self._csizes = np.add.reduceat(self._item_sizes[order], starts)

    def install_partition(
        self,
        partition: CliquePartition,
        now: float,
        window_items: np.ndarray | None = None,
        window_servers: np.ndarray | None = None,
    ) -> None:
        """Translate cache state onto a new partition (host numpy).

        * cliques identical to a previous clique keep their row and anchor;
        * changed cliques are present at j iff EVERY member was nominally
          alive at j (segment-min of member expiries);
        * newly formed multi-item cliques are seeded with one packed copy at
          the server that accessed their members most during the window
          (Alg. 1 line 5), free of charge.
        """
        old = self.state
        k = partition.k
        if k == 0:
            self.state = CacheState.fresh(partition, self.m)
            self._set_partition_caches(partition)
            return
        E = np.zeros((k, self.m), dtype=np.float64)
        anchor = np.full(k, -1, dtype=np.int32)
        new_sizes = partition.sizes().astype(np.int64)
        old_of = old.partition.clique_of

        matched, cand = match_partitions(old.partition, partition)
        E[matched] = old.E[cand[matched]]
        anchor[matched] = old.anchor[cand[matched]]

        changed = ~matched
        if changed.any():
            item_E = old.E[old_of]                       # (n, m)
            order = partition.member_order()             # grouped by clique
            starts = np.zeros(k, np.int64)
            np.cumsum(new_sizes[:-1], out=starts[1:])
            min_E = np.minimum.reduceat(item_E[order], starts, axis=0)
            fresh = np.where(min_E > now, min_E, 0.0)    # (k, m)
            E[changed] = fresh[changed]
            row_max = fresh.max(axis=1)
            present = changed & (row_max > 0)
            anchor[present] = np.argmax(fresh, axis=1)[present].astype(np.int32)

            need_seed = changed & (row_max <= 0) & (new_sizes > 1)
            if (
                self.seed_new_cliques
                and window_items is not None
                and window_servers is not None
                and need_seed.any()
            ):
                js = window_seed_servers(
                    self.n, self.m, partition, window_items, window_servers)
                rows = np.nonzero(need_seed)[0]
                E[rows, js[rows]] = now + self._dt_arr[js[rows]]
                anchor[rows] = js[rows].astype(np.int32)
        self.state = CacheState(partition=partition, E=E, anchor=anchor, m=self.m)
        self._set_partition_caches(partition)
