"""Disjoint clique partitions and the host clique generation (paper §III.C).

A copy of ``repro.core.cliques``: every item belongs to exactly one clique
(singleton by default), so a clique set is a partition of [0, n) and the
cache state is a dense (k, m) expiry matrix.  The Clique Generation
Module on the host:

* Alg. 4 — incremental adjustment of the previous window's cliques from
  the binary-CRM edge diff (remove -> split along the edge, add -> merge
  when the union stays a valid clique);
* Alg. 3 — splitting of cliques larger than omega along weakest
  co-utilisation edges, and approximate merging of clique pairs whose
  union has size exactly omega and edge density >= gamma.

The merge scan is ``X = M A M^T``: the ``pair_edges`` hook runs it on the
card (kernel ``clique_pair_edges``), numpy otherwise; every entry is an
exact small integer in float32, so both give the same partition.  The
AKPC replay with the device clique generation
(:mod:`repro_torch.core.cgm`) runs the same algorithms on the card.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..spans import span
from .crm import WindowCRM, edge_diff_arrays

#: host clique-generation call counter
CGM_CALLS = 0


@dataclasses.dataclass
class CliquePartition:
    """Partition of items [0, n) into disjoint cliques.

    ``cliques``    list of sorted int tuples (includes singletons)
    ``clique_of``  (n,) int32: item id -> clique index

    The array-native views (``sizes``, ``packed``) are derived from
    ``clique_of`` and cached.
    """

    n: int
    cliques: list[tuple[int, ...]]
    clique_of: np.ndarray

    # -- constructors ------------------------------------------------------
    @classmethod
    def singletons(cls, n: int) -> "CliquePartition":
        return cls(
            n=n,
            cliques=[(i,) for i in range(n)],
            clique_of=np.arange(n, dtype=np.int32),
        )

    @classmethod
    def from_cliques(cls, n: int, groups: list[tuple[int, ...]]) -> "CliquePartition":
        """Build a full partition from (disjoint, non-empty) groups.

        Items not covered by ``groups`` become singletons.  Raises
        ``ValueError`` on empty groups, out-of-range item ids and items
        appearing twice — zero-size or aliased clique rows would silently
        corrupt the engine's transfer/rent accounting downstream.
        """
        k = len(groups)
        lens, flat, gidx = _flatten_groups(groups)
        if k and (lens == 0).any():
            raise ValueError(
                f"empty clique group at index {int(np.argmax(lens == 0))}"
            )
        if flat.size:
            bad = (flat < 0) | (flat >= n)
            if bad.any():
                raise ValueError(
                    f"item id {int(flat[bad][0])} outside [0, {n})"
                )
            counts = np.bincount(flat, minlength=n)
            if (counts > 1).any():
                raise ValueError(
                    f"item {int(np.argmax(counts > 1))} in two cliques"
                )
        clique_of = np.full(n, -1, dtype=np.int32)
        clique_of[flat] = gidx.astype(np.int32)
        cliques = [tuple(sorted(g)) for g in groups]
        missing = np.nonzero(clique_of < 0)[0]
        clique_of[missing] = k + np.arange(missing.size, dtype=np.int32)
        cliques.extend((int(d),) for d in missing)
        return cls(n=n, cliques=cliques, clique_of=clique_of)

    # -- views -------------------------------------------------------------
    @property
    def k(self) -> int:
        return len(self.cliques)

    def sizes(self) -> np.ndarray:
        """(k,) int32 clique sizes (cached)."""
        s = getattr(self, "_sizes", None)
        if s is None:
            s = np.bincount(self.clique_of, minlength=self.k).astype(np.int32)
            self._sizes = s
        return s

    def non_singletons(self) -> list[tuple[int, ...]]:
        return [c for c in self.cliques if len(c) > 1]

    def canonical(self) -> list[tuple[int, ...]]:
        """The cliques of two or more items, sorted."""
        return sorted(self.non_singletons())

    def packed(self) -> np.ndarray:
        """(k, max|c|) int64 member ids, -1 padded, rows in clique order.

        Each row lists members in ascending id order (the order of the
        ``cliques`` tuples).
        """
        p = getattr(self, "_packed", None)
        if p is None:
            k = self.k
            sizes = self.sizes().astype(np.int64)
            w = int(sizes.max()) if k else 1
            order = np.argsort(self.clique_of, kind="stable")
            starts = np.zeros(k, np.int64)
            np.cumsum(sizes[:-1], out=starts[1:])
            rows = self.clique_of[order].astype(np.int64)
            col = np.arange(self.n, dtype=np.int64) - starts[rows]
            p = np.full((k, max(w, 1)), -1, dtype=np.int64)
            p[rows, col] = order
            self._packed = p
        return p

    def member_order(self) -> np.ndarray:
        """(n,) int64 item ids sorted by (clique index, item id).

        ``packed()`` without the padding: row boundaries are at
        ``cumsum(sizes())`` — the layout segment reductions run over.
        """
        return np.argsort(self.clique_of, kind="stable")



def _flatten_groups(
    groups: list[tuple[int, ...]],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lens, flat member ids, group index per member) for a group list."""
    k = len(groups)
    lens = np.fromiter(map(len, groups), np.int64, count=k)
    flat = np.fromiter(
        itertools.chain.from_iterable(groups), np.int64, count=int(lens.sum())
    )
    return lens, flat, np.repeat(np.arange(k), lens)


# ---------------------------------------------------------------------------
# weight lookup helpers: CRM matrices are restricted to hot items, items
# outside get weight 0 / no edge.
# ---------------------------------------------------------------------------
class _CrmView:
    """Global-id view over a WindowCRM (cold items have no edges)."""

    def __init__(self, crm: WindowCRM, n: int):
        self._lut = np.full(n, -1, dtype=np.int32)
        self._lut[crm.hot_items] = np.arange(crm.n_hot, dtype=np.int32)
        self._norm = crm.norm
        self._bin = crm.binary

    def weights_submatrix(self, members: np.ndarray) -> np.ndarray:
        """(s, s) float64 normalised weights; cold rows/cols are 0."""
        idx = self._lut[np.asarray(members, dtype=np.int64)]
        s = idx.shape[0]
        W = np.zeros((s, s), dtype=np.float64)
        hot = np.nonzero(idx >= 0)[0]
        if hot.size >= 2:
            W[np.ix_(hot, hot)] = self._norm[np.ix_(idx[hot], idx[hot])]
        return W

    def hot_count(self, members) -> int:
        """Number of hot members of a group."""
        return int((self._lut[np.asarray(members, dtype=np.int64)] >= 0).sum())

    def edges_within(self, group: tuple[int, ...]) -> int:
        idx = self._lut[list(group)]
        idx = idx[idx >= 0]
        if idx.size < 2:
            return 0
        # binary is symmetric with a False diagonal: sum/2 == triu sum
        return int(self._bin[np.ix_(idx, idx)].sum()) // 2

    def fully_connected(self, group: tuple[int, ...]) -> bool:
        g = len(group)
        if g <= 8:
            # tiny unions (the Alg.-4 merge check) are faster as direct
            # element probes than as an np.ix_ submatrix
            lut, bin_ = self._lut, self._bin
            idx = [lut[d] for d in group]
            if any(a < 0 for a in idx):
                return g < 2
            return all(
                bin_[idx[i], idx[j]]
                for i in range(g) for j in range(i + 1, g)
            )
        return self.edges_within(group) == g * (g - 1) // 2


# ---------------------------------------------------------------------------
# Alg. 4 — adjust previous cliques from the edge diff
# ---------------------------------------------------------------------------
def split_clique_on_edge(
    clique: tuple[int, ...], u: int, v: int, view: _CrmView
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Split ``clique`` into two groups seeded at the removed edge (u, v).

    Each remaining member joins the side it is more strongly co-utilised
    with (sum of normalised CRM weights), accumulated as vectors over the
    group's weight submatrix in member order.
    """
    members = np.asarray(clique, dtype=np.int64)
    W = view.weights_submatrix(members)
    pu = int(np.nonzero(members == u)[0][0])
    pv = int(np.nonzero(members == v)[0][0])
    left = [int(u)]
    right = [int(v)]
    wl = W[:, pu].copy()                 # wl[d] = sum of weights d -> left
    wr = W[:, pv].copy()
    for p in range(members.size):
        if p == pu or p == pv:
            continue
        if wl[p] >= wr[p]:
            left.append(int(members[p]))
            wl += W[:, p]
        else:
            right.append(int(members[p]))
            wr += W[:, p]
    return tuple(sorted(left)), tuple(sorted(right))


def adjust_previous_cliques(
    prev: CliquePartition,
    added: np.ndarray,
    removed: np.ndarray,
    view: _CrmView,
    omega: int,
) -> list[tuple[int, ...]]:
    """Alg. 4: reuse the previous partition, patching it edge by edge.

    ``added`` / ``removed`` are (e, 2) int arrays of global-id edges in
    lexicographic order (:func:`~repro_torch.core.crm.edge_diff_arrays`).
    """
    groups: list[tuple[int, ...] | None] = list(prev.cliques)
    of = prev.clique_of.astype(np.int64, copy=True)

    for u, v in np.asarray(removed, dtype=np.int64).tolist():
        cu = int(of[u])
        if cu == int(of[v]) and len(groups[cu]) > 1:
            a, b = split_clique_on_edge(groups[cu], u, v, view)
            groups[cu] = a
            of[list(a)] = cu
            j = len(groups)
            groups.append(b)
            of[list(b)] = j

    for u, v in np.asarray(added, dtype=np.int64).tolist():
        cu, cv = int(of[u]), int(of[v])
        if cu == cv:
            continue
        gu, gv = groups[cu], groups[cv]
        if len(gu) + len(gv) > omega:        # disjoint: |union| = |gu|+|gv|
            continue
        union = tuple(sorted(gu + gv))
        if view.fully_connected(union):
            # a new exact clique is formed (Alg. 4 lines 8-9)
            keep, drop = (cu, cv) if cu < cv else (cv, cu)
            groups[keep] = union
            groups[drop] = None
            of[list(union)] = keep

    return [g for g in groups if g]


# ---------------------------------------------------------------------------
# Alg. 3 lines 2-3 — weakest-edge splitting of oversized cliques
# ---------------------------------------------------------------------------
def split_oversized(
    group: tuple[int, ...], omega: int, view: _CrmView
) -> list[tuple[int, ...]]:
    """Split ``group`` until every part has size <= omega (iterative).

    The cut is seeded at the weakest co-utilisation edge of the group; a
    worklist stands in for the recursion, in the same emission order.
    """
    out: list[tuple[int, ...]] = []
    stack: list[tuple[int, ...]] = [tuple(group)]
    while stack:
        g = stack.pop()
        if len(g) <= omega:
            out.append(g)
            continue
        if view.hot_count(g) <= 1:
            # Every pairwise weight is 0: the weakest edge is always
            # (g[0], g[1]) and ties send every member left, so each level
            # peels g[1] off.  Emit that peel sequence in closed form.
            p = len(g) - omega
            out.append((g[0],) + g[p + 1:])
            out.extend((g[i],) for i in range(p, 0, -1))
            continue
        W = view.weights_submatrix(np.asarray(g, dtype=np.int64))
        W[np.tril_indices(len(g))] = np.inf
        pu, pv = divmod(int(np.argmin(W)), len(g))
        a, b = split_clique_on_edge(g, g[pu], g[pv], view)
        stack.append(b)                  # LIFO: a's splits emit before b's
        stack.append(a)
    return out


# ---------------------------------------------------------------------------
# Alg. 3 lines 4-10 — approximate clique merging
# ---------------------------------------------------------------------------
def hot_membership(
    groups: list[tuple[int, ...]], view: _CrmView
) -> np.ndarray:
    """(k, h) 0/1 membership matrix restricted to the hot index space."""
    h = view._norm.shape[0]
    k = len(groups)
    M = np.zeros((k, h), dtype=np.float32)
    if k:
        _, flat, gidx = _flatten_groups(groups)
        idx = view._lut[flat]
        hot = idx >= 0
        M[gidx[hot], idx[hot]] = 1.0
    return M


def merge_scores(
    groups: list[tuple[int, ...]],
    view: _CrmView,
    omega: int,
    pair_edges=None,
) -> np.ndarray:
    """Density of every pairwise union with |U| == omega; -1 elsewhere.

    With M (k, h) hot membership and A the binary CRM, ``X = M A M^T``
    holds cross-edge counts off-diagonal and 2x within-edge counts on the
    diagonal, so ``E_U(i, j) = X[i,i]/2 + X[j,j]/2 + X[i,j]``.
    ``pair_edges``: optional ``(M, A) -> M A M^T`` on the card (the
    ``clique_pair_edges`` hook); defaults to numpy matmuls.
    """
    k = len(groups)
    M = hot_membership(groups, view)
    A = view._bin.astype(np.float32)
    if pair_edges is None:
        X = M @ A @ M.T
    else:
        X = np.asarray(pair_edges(M, A))
    sizes = np.array([len(g) for g in groups], dtype=np.int64)
    dens = _densities(X, sizes, omega)
    assert dens.shape == (k, k)
    return dens


def _densities(X: np.ndarray, sizes: np.ndarray, omega: int) -> np.ndarray:
    """(k, k) float32 union densities from the pair-edge matrix X."""
    within = np.diag(X) / 2.0
    e_u = within[:, None] + within[None, :] + X
    ok = (sizes[:, None] + sizes[None, :]) == omega
    np.fill_diagonal(ok, False)
    e_max = omega * (omega - 1) / 2.0
    return np.where(ok, e_u / e_max, -1.0).astype(np.float32)


def _mergeable_split(
    groups: list[tuple[int, ...]], view: _CrmView, omega: int, gamma: float
) -> tuple[list[tuple[int, ...]], list[tuple[int, ...]]]:
    """Split groups into (merge candidates, pass-through).

    A group with no hot member has zero CRM edges; its union with any
    partner of size <= omega-1 has at most (omega-1)(omega-2)/2 edges, so
    for gamma > (omega-2)/omega it can never reach the density bar.
    """
    if omega <= 2 or gamma <= (omega - 2) / omega:
        return list(groups), []
    k = len(groups)
    if not k:
        return [], []
    _, flat, gidx = _flatten_groups(groups)
    has_hot = np.bincount(gidx[view._lut[flat] >= 0], minlength=k) > 0
    cand = [g for g, hh in zip(groups, has_hot) if hh]
    rest = [g for g, hh in zip(groups, has_hot) if not hh]
    return cand, rest


def approximate_merge(
    groups: list[tuple[int, ...]],
    view: _CrmView,
    omega: int,
    gamma: float,
    pair_edges=None,
) -> list[tuple[int, ...]]:
    """Greedy best-density-first merging of clique pairs with |U| == omega.

    ``X = M A M^T`` is computed once (numpy, or the ``pair_edges`` hook on
    the card) over the active candidates (groups with at least one
    incident binary-CRM edge), then X and the thresholded density matrix
    D are updated additively after each merge: the merged row/col is the
    sum of its parents, every other entry is untouched.  Ties in the
    argmax go to the first pair (candidate order: survivors in place,
    merged appended).
    """
    cand, rest = _mergeable_split(list(groups), view, omega, gamma)
    k = len(cand)
    if k < 2:
        return cand + rest
    lens, flat, gidx = _flatten_groups(cand)
    idx = view._lut[flat]
    if omega <= 2 or gamma <= (omega - 2) / omega:
        act = np.arange(k)              # low bar: no pruning is sound
    else:
        has_edge = view._bin.any(axis=1)          # (h,) hot item has a peer
        live = (idx >= 0) & has_edge[np.maximum(idx, 0)]
        act = np.nonzero(np.bincount(gidx[live], minlength=k) > 0)[0]
    # X over the active subspace only: inert rows of the full M A M^T are
    # identically zero, and every entry is an exact small integer
    act_of = np.full(k, -1, dtype=np.int64)
    act_of[act] = np.arange(act.size)
    a = int(act.size)
    if pair_edges is not None:
        M = hot_membership([cand[int(t)] for t in act], view)
        A = view._bin.astype(np.float32)
        X = np.asarray(pair_edges(M, A), dtype=np.float32)
    else:
        mem = (act_of[gidx] >= 0) & (idx >= 0)    # hot members of act groups
        fi = idx[mem]
        ga = act_of[gidx[mem]]
        t = fi.size
        S = np.zeros((a, t), dtype=np.float32)
        S[ga, np.arange(t)] = 1.0
        sub = view._bin[np.ix_(fi, fi)].astype(np.float32)
        X = S @ sub @ S.T
    sizes = lens[act]
    act_idx = act                       # cand position of each X/D row
    dens = _densities(X, sizes, omega)
    D = np.where(dens >= gamma, dens, -1.0).astype(np.float32)
    e_max = omega * (omega - 1) / 2.0
    while a >= 2:
        f = int(np.argmax(D))
        ai, aj = divmod(f, a)
        if D[ai, aj] < 0:
            break
        if ai > aj:
            ai, aj = aj, ai
        i, j = int(act_idx[ai]), int(act_idx[aj])     # i < j: idx ascending
        merged = tuple(sorted(cand[i] + cand[j]))
        del cand[j]
        del cand[i]
        cand.append(merged)
        keep = np.ones(a, dtype=bool)
        keep[[ai, aj]] = False
        pos = act_idx[keep]
        act_idx = np.append(pos - (pos > i) - (pos > j), len(cand) - 1)
        row = (X[ai, :] + X[aj, :])[keep]
        diag = X[ai, ai] + X[aj, aj] + 2.0 * X[ai, aj]
        a -= 1
        Xn = np.empty((a, a), dtype=np.float32)
        Xn[:-1, :-1] = X[np.ix_(keep, keep)]
        Xn[-1, :-1] = row
        Xn[:-1, -1] = row
        Xn[-1, -1] = diag
        sizes = np.concatenate([sizes[keep], [sizes[ai] + sizes[aj]]])
        # merged group's density row, same float ops as a full recompute
        within = np.diag(Xn) / 2.0
        e_row = (within[-1] + within[:-1]) + Xn[-1, :-1]
        ok_row = (sizes[-1] + sizes[:-1]) == omega
        d_row = np.where(ok_row, e_row / e_max, -1.0).astype(np.float32)
        d_row = np.where(d_row >= gamma, d_row, -1.0)
        Dn = np.empty((a, a), dtype=np.float32)
        Dn[:-1, :-1] = D[np.ix_(keep, keep)]
        Dn[-1, :-1] = d_row
        Dn[:-1, -1] = d_row
        Dn[-1, -1] = -1.0
        X, D = Xn, Dn
    return cand + rest


# ---------------------------------------------------------------------------
# full Alg. 3 pipeline
# ---------------------------------------------------------------------------
def generate_cliques(
    prev: CliquePartition | None,
    prev_crm: WindowCRM | None,
    crm: WindowCRM,
    n: int,
    omega: int,
    gamma: float,
    pair_edges=None,
    enable_split: bool = True,
    enable_approx_merge: bool = True,
) -> CliquePartition:
    """One clique-generation event: adjust -> split -> approximate-merge.

    ``enable_split`` / ``enable_approx_merge`` implement the paper's
    ablation variants (AKPC w/o CS, w/o ACM).
    """
    global CGM_CALLS
    CGM_CALLS += 1

    view = _CrmView(crm, n)
    if prev is None:
        prev = CliquePartition.singletons(n)
    with span("host_cgm.adjust"):
        added, removed = edge_diff_arrays(prev_crm, crm)
        groups = adjust_previous_cliques(prev, added, removed, view, omega)
    if enable_split:
        out: list[tuple[int, ...]] = []
        with span("host_cgm.split"):
            for g in groups:
                if len(g) <= omega:
                    out.append(g)
                else:
                    out.extend(split_oversized(g, omega, view))
    else:
        out = list(groups)
    if enable_approx_merge:
        with span("host_cgm.merge"):
            out = approximate_merge(out, view, omega, gamma,
                                    pair_edges=pair_edges)
    return CliquePartition.from_cliques(n, out)
