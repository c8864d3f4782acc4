"""Frozen copy of ``src/repro/core/engine.py`` at commit 63887c5 (numpy only).

Part of the benchmark's plain reference: it imports nothing of the
measured package, so a later change to the program cannot move it.

Changes from the copied file: the item -> clique lookup is the numpy
gather alone, ``ReplayEngine(dtype=...)`` keeps the state and the cost
sums in that float type (float64, the configuration's, by default;
float32 is the benchmark's lower-precision control), and the scalar
request wrapper and the offline ``replay`` driver are left out
(:class:`~perfbench.reference.akpc.ReferenceStream` drives the engine).


Cache replay engine shared by AKPC and every baseline (Alg. 1, 5, 6).

State per clique c and edge storage server (ESS) j:

* ``E[c, j]``  nominal expiry of the packed copy of c at j (0 = never cached)
* ``anchor[c]`` the server whose copy Alg. 6 keeps alive:  when a copy
  expires and it is the system's last alive copy (G[c] == 1), its expiry is
  extended by dt — recursively, so the copy with the LATEST nominal expiry
  ratchets forever until some other server fetches a fresher copy.  Hence at
  any time the alive set is ``{j : E[c,j] > t} ∪ {argmax_j E[c,j]}`` and we
  only need to remember the argmax ("anchor").  See DESIGN.md §2.

Cost accounting (Alg. 5 made consistent — see cost.py):

* miss at j   ->  C_T += transfer_cost(|c|, packed=|c|>1)
* every access->  C_P += n_charged * mu * ((t + dt) - max(E_eff, t))
  where ``n_charged`` is |D_i ∩ c| under the paper's accounting (the
  competitive proof and Alg. 5 line 5 charge rent for requested items only),
  or |c| under "stored" accounting (rent for what is actually stored).
* afterwards  ->  E[c, j] = t + dt

Batched state-update semantics (the vectorised hot path)
--------------------------------------------------------

``handle_batch`` replays a whole time-slice of requests with NumPy segment
reductions instead of per-request Python.  Correctness rests on two facts
about the scalar recurrence, both relying on request times being
non-decreasing (guaranteed by ``Trace``):

1. **Anchor resolution order within a batch.**  Every access touches its
   clique with expiry ``t + dt`` and ``dt`` is constant, so ``t + dt`` is the
   row maximum the moment it is written (every earlier expiry was set from an
   earlier time).  Hence after the first access of a clique inside a batch,
   the anchor is simply *the server of the clique's most recent access* —
   the per-event anchor lookup collapses to a lag over events grouped by
   clique (first event of a group checks the pre-batch ``anchor`` array,
   later events compare against the previous event's server).

2. **Segment-max expiry.**  For the same reason, the post-batch expiry of a
   (clique, server) pair is ``t_last + dt`` of its *last* access in the
   batch, and the pre-access expiry seen by any event is ``t_prev + dt`` of
   the previous access of the same pair (or the pre-batch ``E[c, j]`` for the
   pair's first event).  Both are lags/segment-ends over events sorted by
   (clique, server) — no sequential dict updates needed.

Alive-mask, miss transfer costs, Alg.-6 ratcheting/keepalive rent and the
Alg.-5 caching charge are then straight elementwise array math over the
(request, clique) "events" of the batch (deduplicated with multiplicity
|D_i ∩ c| via one ``np.unique`` over packed keys).

**Scalar-wrapper compatibility guarantee:** ``handle_request`` is a thin
wrapper over ``handle_batch`` with a batch of one, and a batch of one
performs exactly the scalar recurrence's float operations in the scalar
order — so per-request replay (``replay(..., batch_size=1)``) is
bit-compatible with the historical per-request Python loop, and larger
batches agree cost-for-cost up to float summation order (see
tests/test_engine_batched.py).

Pluggable cost models + per-server dt (PR 4, DESIGN.md §9)
----------------------------------------------------------

All cost arithmetic is routed through the three batched hooks of a
registered :class:`~repro.core.cost.CostModel` bound to a
:class:`~repro.core.cost.CacheEnvironment` (per-server prices, per-item
sizes).  The default ``table1`` model performs the identical float ops of
the historical inline ``CostParams`` formulas, so default replays stay
bit-identical.

Fact 1 above ("anchor = server of the most recent access") holds ONLY for a
server-constant dt.  When the model's ``dt()`` varies per server
(``heterogeneous``: dt_j = rho*lam_j/mu_j), an earlier access at a
long-dt server can outlive a later access at a short-dt server, so anchor
resolution becomes a RUNNING SEGMENT-MAX over the (clique)-sorted events of
the written expiries ``t_e + dt_{j_e}`` (ties -> latest, matching the
scalar ``touch`` rule's ``>=`` update), seeded per clique with the
pre-batch ``(anchor, E[c, anchor])`` pair.  The scan is a vectorised
Hillis-Steele doubling over the event axis (O(E log E)); the constant-dt
lag fast path is preserved and picked automatically.  Fact 2 is unaffected:
within one (clique, server) pair dt is constant, so pair expiries stay
lags/segment-ends.

The per-batch item->clique membership lookup is routed through
``repro.kernels.packed_lookup.clique_lookup``: the Pallas scalar-prefetch
gather on TPU backends, a NumPy fancy-index everywhere else (including when
JAX is not importable at all).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal

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

#: default time-slice size for batched replay (requests per handle_batch)
DEFAULT_BATCH_SIZE = 4096


def _numpy_clique_lookup(clique_of: np.ndarray, items: np.ndarray) -> np.ndarray:
    """Fallback membership gather used when the kernels package is absent."""
    return np.asarray(clique_of)[np.asarray(items)]


@dataclasses.dataclass
class CacheState:
    """Dense per-(clique, server) cache bookkeeping."""

    partition: CliquePartition
    E: np.ndarray               # (k, m) float64 nominal expiries
    anchor: np.ndarray          # (k,) int32, -1 if clique never cached
    m: int

    @classmethod
    def fresh(cls, partition: CliquePartition, m: int,
              dtype=np.float64) -> "CacheState":
        k = partition.k
        return cls(
            partition=partition,
            E=np.zeros((k, m), dtype=dtype),
            anchor=np.full(k, -1, dtype=np.int32),
            m=m,
        )

    @classmethod
    def from_device(cls, partition: CliquePartition, E, anchor,
                    m: int) -> "CacheState":
        """Slice device-layout state arrays (any StateLayout: dense
        ``(n+1, m)``, bucketed or row-sharded padding) back to the live
        ``(k, m)`` host prefix — host state is dense under every layout."""
        k = partition.k
        return cls(
            partition=partition,
            E=np.asarray(E)[:k, :m].astype(np.float64, copy=True),
            anchor=np.asarray(anchor)[:k].astype(np.int32, copy=True),
            m=m,
        )

    # -- aliveness ---------------------------------------------------------
    def is_alive(self, c: int, j: int, t: float) -> bool:
        if self.E[c, j] > t:
            return True
        return self.anchor[c] == j and self.E[c, j] > 0.0

    def ratcheted_expiry(self, c: int, j: int, t: float, dt: float) -> float:
        """Effective expiry of an alive copy at time t (Alg. 6 ratcheting)."""
        e = self.E[c, j]
        if e > t:
            return e
        # anchor copy whose nominal expiry lapsed: extended in dt steps
        steps = np.ceil((t - e) / dt)
        r = e + steps * dt
        if r <= t:                       # t exactly on a step boundary
            r += dt
        return float(r)

    def alive_copies(self, c: int, t: float) -> int:
        """G[c]: number of alive copies of clique c."""
        g = int((self.E[c] > t).sum())
        a = self.anchor[c]
        if a >= 0 and self.E[c, a] <= t and self.E[c, a] > 0.0:
            g += 1
        return g

    def touch(self, c: int, j: int, new_expiry: float) -> None:
        self.E[c, j] = new_expiry
        a = self.anchor[c]
        if a < 0 or new_expiry >= self.E[c, a]:
            self.anchor[c] = j


@dataclasses.dataclass
class BatchOutcome:
    """Per-(request, clique) event arrays of one handle_batch call.

    Events are sorted by (request index, clique id) — the same order the
    scalar loop visits them.  All arrays share the event axis.
    """

    req: np.ndarray            # (e,) int64 request index within the batch
    cliques: np.ndarray        # (e,) int64 clique id
    n_req: np.ndarray          # (e,) int64 |D_i ∩ c| multiplicity
    miss: np.ndarray           # (e,) bool
    transfer: np.ndarray       # (e,) float64 (0 for hits)
    caching: np.ndarray        # (e,) float64 Alg.-5 caching charge

    @property
    def n_events(self) -> int:
        return int(self.req.shape[0])


@dataclasses.dataclass
class BatchEvents:
    """STATE-FREE event construction of one request batch.

    Everything here is a pure function of (partition, batch requests) — no
    cache state enters — which is what lets the JAX backend
    (``core/engine_jax.py``) hoist the whole construction into a host-built
    replay schedule and keep only the state recurrence on device.  The
    arrays are exactly the intermediates ``handle_batch`` historically
    computed inline, in the same NumPy op order (bit-compat contract).
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
    # constant-dt fast-path lags (module docstring fact 1)
    first_c: np.ndarray        # (e,) bool first event of its clique (dense)
    prev_j: np.ndarray         # (e,) int64 previous same-clique server
    n_valid: int               # number of valid (non-padding) item slots

    @property
    def n_events(self) -> int:
        return int(self.ev_c.shape[0])


def batch_events(
    clique_of: np.ndarray,
    k: int,
    m: int,
    items: np.ndarray,
    servers: np.ndarray,
    times: np.ndarray,
    lookup: Callable[[np.ndarray, np.ndarray], np.ndarray],
    item_sizes: np.ndarray | None,
) -> BatchEvents:
    """Construct the deduplicated (request, clique) events of one batch.

    ``items`` (B, d_max) int -1-padded, ``servers`` (B,), ``times`` (B,)
    as in :meth:`ReplayEngine.handle_batch` (already atleast_2d/reshaped).
    Performs the identical float/int NumPy ops the engine's inline
    construction performed, in the same order.
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

    # --- items -> cliques (Pallas gather on TPU, numpy otherwise) ---------
    flat_r = np.broadcast_to(np.arange(B)[:, None], items.shape)[valid]
    cl = np.asarray(lookup(clique_of, items[valid]), dtype=np.int64)

    # --- dedupe (request, clique) pairs, keep |D_i ∩ c| counts ------------
    # unique over packed keys sorts by (request, clique) — the order the
    # scalar loop visits cliques
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

    # --- within-batch lags (module docstring, facts 1 and 2) --------------
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

    # constant-dt fast path lags (fact 1): previous same-clique server
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

    State-free half of :meth:`ReplayEngine.install_partition` (shared with
    the JAX schedule builder).  A new clique equals an old one iff all its
    members map to one old clique of the same size.
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
    window (Alg. 1 line 5 seeding target).  State-free half of the
    ``install_partition`` seed path."""
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
    """Replays a request trace against an evolving clique partition.

    The replay core is batched: ``handle_batch`` vectorises Alg. 5/6 over a
    time-slice of requests (see module docstring for the exact semantics);
    ``handle_request`` wraps it for single requests and ``replay`` slices the
    trace into batches that never straddle a T_CG boundary.
    """

    def __init__(
        self,
        n: int,
        m: int,
        params: CostParams | None = None,
        caching_charge: CachingCharge = "requested",
        seed_new_cliques: bool = True,
        lookup: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None,
        env: CacheEnvironment | None = None,
        cost_model: str | CostModel = "table1",
        dtype=np.float64,
    ):
        self.n = n
        self.m = m
        self.dtype = np.dtype(dtype)
        # float64 sums stay Python floats (the copied file's arithmetic)
        self._scalar = float if self.dtype == np.float64 else self.dtype.type
        if env is None:
            env = CacheEnvironment(n=n, m=m, params=params or CostParams())
        elif (env.n, env.m) != (n, m):
            raise ValueError(
                f"environment shape ({env.n}, {env.m}) != engine ({n}, {m})")
        elif params is not None and params != env.params:
            # the bound cost model prices via env.params; a conflicting
            # explicit params would be silently ignored otherwise
            raise ValueError(
                "params and env.params disagree; build the environment with "
                "the same CostParams you pass to the engine/policy")
        self.env = env
        self.params = params if params is not None else env.params
        self.model = get_cost_model(cost_model, env)
        self._dt_arr = np.asarray(self.model.dt(), dtype=self.dtype)
        self._dt_const = m == 0 or bool((self._dt_arr == self._dt_arr[0]).all())
        self._item_sizes = env.sizes() if self.model.uses_sizes else None
        self.caching_charge = caching_charge
        self.seed_new_cliques = seed_new_cliques
        self._lookup = _numpy_clique_lookup if lookup is None else lookup
        self._item_keep: np.ndarray | None = None
        self._clique_nk: np.ndarray | None = None
        self.state = CacheState.fresh(CliquePartition.singletons(n), m,
                                      self.dtype)
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
        self._refresh_clique_nk(partition)

    def _refresh_clique_nk(self, partition: CliquePartition) -> None:
        """Clique-level keep-or-not mask: nokeep iff ANY member is nokeep."""
        if self._item_keep is None or partition.k == 0:
            self._clique_nk = None
            return
        order = partition.member_order()
        starts = np.zeros(partition.k, np.int64)
        np.cumsum(self._sizes[:-1], out=starts[1:])
        nk = (~self._item_keep).astype(np.int64)
        self._clique_nk = np.add.reduceat(nk[order], starts) > 0

    # ------------------------------------------------------------------
    # keep-or-not masks (TTL baseline, arXiv 1312.0499)
    # ------------------------------------------------------------------
    def set_item_keep(
        self, keep: np.ndarray | None, evict: bool = True
    ) -> None:
        """Install a per-item keep-or-not mask.

        Items with ``keep[i] == False`` are never cached: every access of a
        clique containing one is a forced miss priced as a full transfer
        with zero caching/keepalive charge, and the clique's state writes
        are suppressed.  With ``evict=True`` (the window-boundary sync),
        cliques containing an item that JUST flipped keep->nokeep drop
        their cached copies (E row zeroed, anchor cleared); cliques that
        stayed nokeep already hold no state — the invariant "nokeep clique
        => zero state" is maintained at every boundary.  ``None`` removes
        the mask entirely.
        """
        if keep is None:
            self._item_keep = None
            self._clique_nk = None
            return
        keep = np.asarray(keep, dtype=bool)
        if keep.shape != (self.n,):
            raise ValueError(f"keep mask shape {keep.shape} != ({self.n},)")
        old = self._item_keep
        self._item_keep = keep.copy()
        self._refresh_clique_nk(self.state.partition)
        if not evict or self._clique_nk is None:
            return
        newly_nk = ~keep if old is None else (old & ~keep)
        if newly_nk.any():
            rows = np.unique(
                self.state.partition.clique_of[np.nonzero(newly_nk)[0]])
            self.state.E[rows] = 0.0
            self.state.anchor[rows] = -1

    # ------------------------------------------------------------------
    # Alg. 1 Event 1 — install a freshly generated partition
    # ------------------------------------------------------------------
    def install_partition(
        self,
        partition: CliquePartition,
        now: float,
        window_items: np.ndarray | None = None,
        window_servers: np.ndarray | None = None,
    ) -> None:
        """Translate cache state onto the new partition (vectorised).

        * cliques identical to a previous clique keep their row (and anchor):
          matched without hashing tuples — a new clique equals an old one iff
          all its members map to one old clique of the same size;
        * changed cliques are present at j iff EVERY member was nominally
          alive at j (presence = segment-min of member expiries over the
          partition's packed member order);
        * newly formed multi-item cliques are seeded with one packed copy at
          the server that accessed their members most during the window
          (Alg. 1 line 5), free of charge (packing runs in the background,
          §III.C).
        """
        old = self.state
        k = partition.k
        if k == 0:
            self.state = CacheState.fresh(partition, self.m, self.dtype)
            self._set_partition_caches(partition)
            return
        E = np.zeros((k, self.m), dtype=self.dtype)
        anchor = np.full(k, -1, dtype=np.int32)
        new_sizes = partition.sizes().astype(np.int64)
        old_of = old.partition.clique_of

        # -- set-equality match against the old partition ------------------
        matched, cand = match_partitions(old.partition, partition)
        E[matched] = old.E[cand[matched]]
        anchor[matched] = old.anchor[cand[matched]]

        changed = ~matched
        if changed.any():
            # nominal per-item expiry under the old partition
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
                # never seed a clique holding a keep-or-not evicted item:
                # its state must stay zero until the mask flips back
                has_nk = np.add.reduceat(
                    (~self._item_keep)[order].astype(np.int64), starts) > 0
                need_seed &= ~has_nk
            if (
                self.seed_new_cliques
                and window_items is not None
                and window_servers is not None
                and need_seed.any()
            ):
                # item -> per-server access counts over the window
                js = window_seed_servers(
                    self.n, self.m, partition, window_items, window_servers)
                rows = np.nonzero(need_seed)[0]
                E[rows, js[rows]] = now + self._dt_arr[js[rows]]
                anchor[rows] = js[rows].astype(np.int32)
        self.state = CacheState(partition=partition, E=E, anchor=anchor, m=self.m)
        self._set_partition_caches(partition)

    # ------------------------------------------------------------------
    # Alg. 5 — request handling, one batch at a time
    # ------------------------------------------------------------------
    def handle_batch(
        self,
        items: np.ndarray,
        servers: np.ndarray,
        times: np.ndarray,
    ) -> BatchOutcome:
        """Vectorised Alg. 5/6 over a batch of requests.

        ``items``  (B, d_max) int, -1 padded;  ``servers`` (B,) int;
        ``times``  (B,) float, non-decreasing and >= every earlier request.
        Rows whose items are all -1 are counted as (empty) requests but
        produce no events.
        """
        st = self.state
        model = self.model
        items = np.atleast_2d(np.asarray(items))
        B = items.shape[0]
        servers = np.asarray(servers, dtype=np.int64).reshape(B)
        times = np.asarray(times, dtype=self.dtype).reshape(B)
        dtype, f = self.dtype, self._scalar

        self.costs.n_requests += B
        k = st.partition.k
        ev = batch_events(
            st.partition.clique_of, k, self.m, items, servers, times,
            self._lookup, self._item_sizes if self._csizes is not None else None,
        )
        self.costs.n_item_requests += ev.n_valid
        if ev.n_valid == 0:
            z = np.zeros(0)
            return BatchOutcome(
                req=z.astype(np.int64), cliques=z.astype(np.int64),
                n_req=z.astype(np.int64), miss=z.astype(bool),
                transfer=z, caching=z,
            )
        ev_r, ev_c, ev_j, ev_t = ev.ev_r, ev.ev_c, ev.ev_j, ev.ev_t
        n_req, req_size = ev.n_req, ev.req_size
        ne = ev.n_events
        o_c, cs, first_c_s = ev.o_c, ev.cs, ev.first_c_s
        o_cj = ev.o_cj

        # per-event dt: scalar on the constant-dt fast path (bit-identical
        # broadcasting), per-server gather otherwise
        if self._dt_const:
            dt_e: np.ndarray | float = f(
                self._dt_arr[0] if self._dt_arr.size else self.params.dt
            )
        else:
            dt_e = self._dt_arr[ev_j]

        E_before = np.where(ev.first_cj, st.E[ev_c, ev_j],
                            ev.prev_cj_t + dt_e).astype(dtype, copy=False)

        # --- anchor resolution --------------------------------------------
        if self._dt_const:
            # fast path (fact 1): anchor == server of the clique's previous
            # event; first events consult the pre-batch anchor array
            anchor_alive = np.where(
                ev.first_c,
                (st.anchor[ev_c] == ev_j) & (E_before > 0.0),
                ev.prev_j == ev_j,
            )
        else:
            anchor_seen, final_lc, final_anchor = self._anchor_scan(
                ev_t, ev_j, ev_c, dt_e, o_c, cs, first_c_s)
            anchor_alive = (anchor_seen == ev_j) & (E_before > 0.0)

        fresh = E_before > ev_t
        if self._clique_nk is not None:
            # keep-or-not (TTL) cliques are forced misses — the in-batch
            # lag chains would otherwise fabricate hits from state writes
            # the nokeep mask suppresses below
            nk_ev = self._clique_nk[ev_c]
            fresh = fresh & ~nk_ev
            anchor_alive = anchor_alive & ~nk_ev
        else:
            nk_ev = None
        alive = fresh | anchor_alive
        miss = ~alive

        # Alg. 6 ratcheting of lapsed anchor copies (+ lazily accounted rent)
        lapsed = alive & ~fresh
        steps = np.ceil((ev_t - E_before) / dt_e)
        r = E_before + steps * dt_e
        r = np.where(r <= ev_t, r + dt_e, r)
        e_eff = np.where(fresh, E_before, np.where(lapsed, r, ev_t))

        # --- costs (vectorized CostModel hooks) ---------------------------
        size = self._sizes[ev_c]
        csize = self._csizes[ev_c] if self._csizes is not None else size
        rate_stored = model.caching_rate(size, csize, ev_j).astype(
            dtype, copy=False)
        rent = np.where(lapsed, rate_stored * (e_eff - E_before), 0.0)

        tc = np.where(miss, model.transfer_cost_batch(size, csize, ev_j),
                      0.0).astype(dtype, copy=False)

        if self.caching_charge == "requested":
            rate = model.caching_rate(
                n_req, req_size if req_size is not None else n_req,
                ev_j).astype(dtype, copy=False)
        else:
            rate = rate_stored
        dur = np.maximum((ev_t + dt_e) - np.maximum(e_eff, ev_t), 0.0)
        ccost = rate * dur
        if nk_ev is not None:
            ccost = np.where(nk_ev, 0.0, ccost)   # nokeep: nothing is stored

        c = self.costs
        c.transfer = float(f(c.transfer) + tc.sum(dtype=dtype))
        c.caching = float(f(c.caching) + ccost.sum(dtype=dtype))
        c.keepalive_rent = float(f(c.keepalive_rent) + rent.sum(dtype=dtype))
        nm = int(miss.sum())
        self.costs.n_misses += nm
        self.costs.n_hits += ne - nm
        self.costs.items_transferred += int(size[miss].sum())

        # --- state update: segment-last expiry + final anchor -------------
        # (nokeep cliques never store state: their writes are filtered out)
        li = o_cj[ev.last_cj_s]
        if nk_ev is not None:
            li = li[~nk_ev[li]]
        if self._dt_const:
            st.E[ev_c[li], ev_j[li]] = ev_t[li] + dt_e
        else:
            st.E[ev_c[li], ev_j[li]] = ev_t[li] + self._dt_arr[ev_j[li]]

        if self._dt_const:
            lc = o_c[ev.last_c_s]
            if nk_ev is not None:
                lc = lc[~nk_ev[lc]]
            # guard (matters only for out-of-order manual calls): keep the
            # old anchor when its expiry still beats the batch's last touch
            a_cur = st.anchor[ev_c[lc]].astype(np.int64)
            a_E = st.E[ev_c[lc], np.maximum(a_cur, 0)]
            upd = (a_cur < 0) | (ev_t[lc] + dt_e >= a_E)
            st.anchor[ev_c[lc[upd]]] = ev_j[lc[upd]]
        else:
            if nk_ev is not None:
                keepc = ~self._clique_nk[final_lc]
                final_lc, final_anchor = final_lc[keepc], final_anchor[keepc]
            st.anchor[final_lc] = final_anchor

        return BatchOutcome(
            req=ev_r, cliques=ev_c, n_req=n_req, miss=miss,
            transfer=tc, caching=ccost,
        )

    def _anchor_scan(
        self,
        ev_t: np.ndarray,
        ev_j: np.ndarray,
        ev_c: np.ndarray,
        dt_e: np.ndarray,
        o_c: np.ndarray,
        cs: np.ndarray,
        first_c_s: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-server-dt anchor resolution (general path, DESIGN.md §9).

        Replays the scalar ``touch`` anchor recurrence — ``anchor := j`` iff
        ``t + dt_j >= E[c, anchor]`` — as a segmented RUNNING ARGMAX (ties ->
        latest) over the written expiries ``e = t + dt_j`` of each clique's
        events, seeded with the pre-batch ``(anchor, E[c, anchor])``.
        Returns ``(anchor_seen, final_cliques, final_anchor)``: the anchor
        each event observes BEFORE it touches, and the post-batch anchor per
        touched clique.
        """
        st = self.state
        ne = ev_t.shape[0]
        e_val = ev_t + dt_e
        js = ev_j[o_c]
        v = e_val[o_c].copy()
        bidx = np.arange(ne, dtype=np.int64)
        # Hillis-Steele doubling: after each round, (v, bidx)[i] is the max
        # written expiry (and its latest writer) over a suffix window of the
        # clique segment ending at i; segments are contiguous in `cs`, so
        # rounds beyond the longest segment are no-ops — bound d by it
        starts = np.nonzero(first_c_s)[0]
        max_run = int(np.diff(np.append(starts, ne)).max())
        d = 1
        while d < max_run:
            same = cs[d:] == cs[:-d]
            take = same & (v[:-d] > v[d:])      # earlier wins only if STRICTLY
            v[d:] = np.where(take, v[:-d], v[d:])
            bidx[d:] = np.where(take, bidx[:-d], bidx[d:])
            d <<= 1

        # pre-batch seed per event (clique-constant): (anchor, E[c, anchor])
        a0 = st.anchor[ev_c].astype(np.int64)
        Ea0 = np.where(
            a0 >= 0, st.E[ev_c, np.maximum(a0, 0)], -np.inf)
        a0_s = a0[o_c]
        Ea0_s = Ea0[o_c]

        # anchor seen by event i = combine(seed, prefix up to i-1)
        prev_v = np.full(ne, -np.inf)
        prev_v[1:] = v[:-1]
        prev_v[first_c_s] = -np.inf
        prev_b = np.zeros(ne, dtype=np.int64)
        prev_b[1:] = bidx[:-1]
        prev_b[first_c_s] = 0
        inbatch = ~first_c_s & (prev_v >= Ea0_s)
        anchor_seen_s = np.where(inbatch, js[prev_b], a0_s)
        anchor_seen = np.empty(ne, dtype=np.int64)
        anchor_seen[o_c] = anchor_seen_s

        # post-batch anchor per clique = combine(seed, full segment)
        last_c_s = np.ones(ne, dtype=bool)
        last_c_s[:-1] = cs[1:] != cs[:-1]
        lasts = np.nonzero(last_c_s)[0]
        win = v[lasts] >= Ea0_s[lasts]
        final_anchor = np.where(
            win, js[bidx[lasts]], a0_s[lasts]).astype(np.int32)
        return anchor_seen, cs[lasts], final_anchor
