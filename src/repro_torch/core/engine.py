"""Cache state, event construction and environment of one replay (Alg. 1, 5, 6).

The host half of ``repro.core.engine``: the dense per-(clique, server)
:class:`CacheState`; :func:`batch_events`, the STATE-FREE (request,
clique) event construction of one request batch that the host-schedule
replay (:mod:`repro_torch.core.schedule`) packs into its step tensors;
and :class:`ReplayEngine`, the holder of state, cost model, environment,
keep-or-not mask and running :class:`CostBreakdown` that
:class:`repro_torch.core.replay.TorchReplayEngine` wraps.  The state
recurrence itself (Alg. 5/6 per request batch) runs on the device in
:mod:`repro_torch.core.replay` and :mod:`repro_torch.core.cgm`; this
module translates state onto an initial partition and keeps the
per-clique size caches.

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


def _numpy_clique_lookup(clique_of: np.ndarray, items: np.ndarray) -> np.ndarray:
    """The plain host membership gather (``build_schedule``'s default
    lookup); -1 padding slots stay -1."""
    items = np.asarray(items)
    return np.where(items < 0, -1, np.asarray(clique_of)[np.maximum(items, 0)])


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

    @classmethod
    def from_device(cls, partition: CliquePartition, E, anchor,
                    m: int) -> "CacheState":
        """Slice device-layout state arrays (host copies of the dense
        ``(n+1, m)`` state, or its live prefix) back to the live
        ``(k, m)`` host state."""
        k = partition.k
        return cls(
            partition=partition,
            E=np.asarray(E)[:k, :m].astype(np.float64, copy=True),
            anchor=np.asarray(anchor)[:k].astype(np.int32, copy=True),
            m=m,
        )


@dataclasses.dataclass
class BatchEvents:
    """STATE-FREE event construction of one request batch.

    Everything here is a pure function of (partition, batch requests); no
    cache state enters, which is what lets the host-schedule replay
    hoist the construction into host-built step tensors and keep only the
    state recurrence on the device.  The arrays are the intermediates of
    ``repro``'s ``handle_batch``, in the same NumPy op order.
    """

    ev_r: np.ndarray           # (e,) int64 request index within the batch
    ev_c: np.ndarray           # (e,) int64 clique id
    ev_j: np.ndarray           # (e,) int64 server of the event's request
    ev_t: np.ndarray           # (e,) float64 request time
    n_req: np.ndarray          # (e,) int64 |D_i ∩ c| multiplicity
    req_size: np.ndarray | None  # (e,) float64 requested-member volume
    # (clique)-sorted view: events grouped by clique, time order inside
    o_c: np.ndarray            # (e,) argsort by clique (stable)
    cs: np.ndarray             # (e,) ev_c[o_c]
    first_c_s: np.ndarray      # (e,) bool segment starts in sorted order
    last_c_s: np.ndarray       # (e,) bool segment ends in sorted order
    # (clique, server)-sorted view
    o_cj: np.ndarray           # (e,) argsort by (clique, server) (stable)
    first_cj_s: np.ndarray     # (e,) bool pair-segment starts (sorted)
    last_cj_s: np.ndarray      # (e,) bool pair-segment ends (sorted)
    first_cj: np.ndarray       # (e,) bool first event of its pair (dense)
    prev_cj_t: np.ndarray      # (e,) float64 previous same-pair event time
    # constant-dt lags: anchor == server of the clique's previous event
    first_c: np.ndarray        # (e,) bool first event of its clique (dense)
    prev_j: np.ndarray         # (e,) int64 previous same-clique server
    n_valid: int               # number of valid (non-padding) item slots

    @property
    def n_events(self) -> int:
        return int(self.ev_c.shape[0])


def batch_events(
    k: int,
    m: int,
    items: np.ndarray,
    servers: np.ndarray,
    times: np.ndarray,
    cliques: np.ndarray | None,
    item_sizes: np.ndarray | None,
) -> BatchEvents:
    """Construct the deduplicated (request, clique) events of one batch.

    ``items`` (B, d_max) int -1-padded, ``servers`` (B,), ``times`` (B,);
    ``cliques`` the clique ids of ``items[items >= 0]`` in that order (the
    caller's lookup: ``build_schedule`` makes one a partition stretch),
    None for a batch without valid items.
    """
    B = items.shape[0]
    valid = items >= 0
    n_valid = int(valid.sum())
    if n_valid == 0:
        z64 = np.zeros(0, np.int64)
        zf = np.zeros(0, np.float64)
        zb = np.zeros(0, bool)
        return BatchEvents(
            ev_r=z64, ev_c=z64, ev_j=z64, ev_t=zf, n_req=z64,
            req_size=zf if item_sizes is not None and k > 0 else None,
            o_c=z64, cs=z64, first_c_s=zb, last_c_s=zb,
            o_cj=z64, first_cj_s=zb, last_cj_s=zb,
            first_cj=zb, prev_cj_t=zf, first_c=zb, prev_j=z64,
            n_valid=0,
        )

    # --- items -> cliques (looked up by the caller) ------------------------
    flat_r = np.broadcast_to(np.arange(B)[:, None], items.shape)[valid]
    cl = np.asarray(cliques, dtype=np.int64)

    # --- dedupe (request, clique) pairs, keep |D_i ∩ c| counts ------------
    # unique over packed keys sorts by (request, clique)
    if item_sizes is not None and k > 0:
        ev_key, inv, n_req = np.unique(
            flat_r * k + cl, return_inverse=True, return_counts=True)
        # summed sizes of the REQUESTED items of each event (|D_i ∩ c|)
        req_size = np.bincount(
            inv.reshape(-1), weights=item_sizes[items[valid]],
            minlength=ev_key.shape[0])
    else:
        ev_key, n_req = np.unique(flat_r * k + cl, return_counts=True)
        req_size = None
    ev_r = ev_key // k
    ev_c = ev_key % k
    ev_j = servers[ev_r]
    ev_t = times[ev_r]
    ne = ev_key.shape[0]

    # --- within-batch lags -------------------------------------------------
    o_c = np.argsort(ev_c, kind="stable")          # (clique, time) order
    cs = ev_c[o_c]
    first_c_s = np.ones(ne, dtype=bool)
    first_c_s[1:] = cs[1:] != cs[:-1]
    last_c_s = np.ones(ne, dtype=bool)
    last_c_s[:-1] = cs[1:] != cs[:-1]

    # per (clique, server): previous event's time -> pre-access expiry
    key_cj = ev_c * m + ev_j
    o_cj = np.argsort(key_cj, kind="stable")
    kcs = key_cj[o_cj]
    first_cj_s = np.ones(ne, dtype=bool)
    first_cj_s[1:] = kcs[1:] != kcs[:-1]
    last_cj_s = np.ones(ne, dtype=bool)
    last_cj_s[:-1] = kcs[1:] != kcs[:-1]
    prev_t_s = np.zeros(ne, dtype=np.float64)
    prev_t_s[1:] = ev_t[o_cj][:-1]
    prev_t_s[first_cj_s] = 0.0
    first_cj = np.empty(ne, dtype=bool)
    first_cj[o_cj] = first_cj_s
    prev_cj_t = np.empty(ne, dtype=np.float64)
    prev_cj_t[o_cj] = prev_t_s

    # constant-dt lags: previous same-clique server
    prev_j_s = np.full(ne, -1, dtype=np.int64)
    prev_j_s[1:] = ev_j[o_c][:-1]
    prev_j_s[first_c_s] = -1
    first_c = np.empty(ne, dtype=bool)
    first_c[o_c] = first_c_s
    prev_j = np.empty(ne, dtype=np.int64)
    prev_j[o_c] = prev_j_s

    return BatchEvents(
        ev_r=ev_r, ev_c=ev_c, ev_j=ev_j, ev_t=ev_t, n_req=n_req,
        req_size=req_size,
        o_c=o_c, cs=cs, first_c_s=first_c_s, last_c_s=last_c_s,
        o_cj=o_cj, first_cj_s=first_cj_s, last_cj_s=last_cj_s,
        first_cj=first_cj, prev_cj_t=prev_cj_t,
        first_c=first_c, prev_j=prev_j, n_valid=n_valid,
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
    per-clique size caches, the keep-or-not mask and the running
    :class:`CostBreakdown`.  The replay runs in
    :class:`repro_torch.core.replay.TorchReplayEngine`.
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
        self._item_keep: np.ndarray | None = None
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

    def set_item_keep(self, keep: np.ndarray | None) -> None:
        """Record the per-item keep-or-not mask (the TTL baseline) after a
        replay; the device replay has already applied its boundary
        evictions.  ``install_partition`` reads it so as never to seed a
        clique holding a nokeep item.  ``None`` removes the mask."""
        if keep is None:
            self._item_keep = None
            return
        keep = np.asarray(keep, dtype=bool)
        if keep.shape != (self.n,):
            raise ValueError(f"keep mask shape {keep.shape} != ({self.n},)")
        self._item_keep = keep.copy()

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
            if self._item_keep is not None and need_seed.any():
                # never seed a clique holding a keep-or-not evicted item
                has_nk = np.add.reduceat(
                    (~self._item_keep)[order].astype(np.int64), starts) > 0
                need_seed &= ~has_nk
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
