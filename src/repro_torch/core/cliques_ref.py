"""Scalar Clique Generation Module: the port's copy of the parity oracle.

The port's own copy of ``repro.core.cliques_ref``: the pre-vectorization
implementation of Alg. 3/4, kept as written, the slow and obviously
correct yardstick that ``python -m repro_torch.bench.fig9 --smoke`` times
the port's clique generation against on the same machine.  It holds its
partitions element for element equal to the reference's copy
(``tests/test_torch_figs.py``).  Do not optimise this module: its value
is that it never changes.

Known (intentional) limitations, fixed only in the fast path:

* ``split_oversized`` recurses once per split, so groups a few thousand
  members over omega raise ``RecursionError``;
* ``approximate_merge`` re-runs the full two-matmul ``merge_scores`` scan
  after every single merge (O(k^3 h) per window).
"""
from __future__ import annotations

import numpy as np

from .cliques import CliquePartition
from .crm import WindowCRM

Edge = tuple[int, int]


def _edge_set(crm: WindowCRM) -> set[Edge]:
    """Binary edges as a set of (global_u, global_v), u < v."""
    iu, iv = np.nonzero(np.triu(crm.binary, k=1))
    return {(int(a), int(b))
            for a, b in zip(crm.hot_items[iu], crm.hot_items[iv])}


def edge_diff(prev: WindowCRM | None,
              cur: WindowCRM) -> tuple[set[Edge], set[Edge]]:
    """Delta-E between consecutive binary CRMs as Python sets (the
    oracle's form): (added_edges, removed_edges) in global item ids."""
    cur_edges = _edge_set(cur)
    prev_edges = _edge_set(prev) if prev is not None else set()
    return cur_edges - prev_edges, prev_edges - cur_edges


class _CrmView:
    """Frozen copy of the legacy global-id view over a WindowCRM.

    Deliberately NOT shared with ``cliques._CrmView`` — the fast module's
    view methods evolve with the fast path, and an oracle that imports
    them would mask a regression on both sides of the parity assertion.
    """

    def __init__(self, crm: WindowCRM, n: int):
        self._lut = np.full(n, -1, dtype=np.int32)
        self._lut[crm.hot_items] = np.arange(crm.n_hot, dtype=np.int32)
        self._norm = crm.norm
        self._bin = crm.binary

    def weight(self, u: int, v: int) -> float:
        a, b = self._lut[u], self._lut[v]
        if a < 0 or b < 0:
            return 0.0
        return float(self._norm[a, b])

    def connected(self, u: int, v: int) -> bool:
        a, b = self._lut[u], self._lut[v]
        if a < 0 or b < 0:
            return False
        return bool(self._bin[a, b])

    def edges_within(self, group: tuple[int, ...]) -> int:
        idx = self._lut[list(group)]
        idx = idx[idx >= 0]
        if idx.size < 2:
            return 0
        sub = self._bin[np.ix_(idx, idx)]
        return int(np.triu(sub, k=1).sum())

    def fully_connected(self, group: tuple[int, ...]) -> bool:
        g = len(group)
        return self.edges_within(group) == g * (g - 1) // 2


# ---------------------------------------------------------------------------
# Alg. 4 — adjust previous cliques from the edge diff
# ---------------------------------------------------------------------------
def split_clique_on_edge(
    clique: tuple[int, ...], u: int, v: int, view: _CrmView
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Split ``clique`` into two groups seeded at the removed edge (u, v)."""
    left = [u]
    right = [v]
    for d in clique:
        if d == u or d == v:
            continue
        wl = sum(view.weight(d, x) for x in left)
        wr = sum(view.weight(d, x) for x in right)
        (left if wl >= wr else right).append(d)
    return tuple(sorted(left)), tuple(sorted(right))


def adjust_previous_cliques(
    prev: CliquePartition,
    added: set[Edge],
    removed: set[Edge],
    view: _CrmView,
    omega: int,
) -> list[tuple[int, ...]]:
    """Alg. 4: reuse the previous partition, patching it edge by edge."""
    groups: list[set[int]] = [set(c) for c in prev.cliques]
    of = prev.clique_of.copy()

    def _replace(idx: int, parts: list[set[int]]) -> None:
        groups[idx] = parts[0]
        for d in parts[0]:
            of[d] = idx
        for p in parts[1:]:
            j = len(groups)
            groups.append(p)
            for d in p:
                of[d] = j

    for (u, v) in sorted(removed):
        cu = int(of[u])
        if cu == int(of[v]) and len(groups[cu]) > 1:
            a, b = split_clique_on_edge(tuple(sorted(groups[cu])), u, v, view)
            _replace(cu, [set(a), set(b)])

    for (u, v) in sorted(added):
        cu, cv = int(of[u]), int(of[v])
        if cu == cv:
            continue
        union = groups[cu] | groups[cv]
        if len(union) <= omega and view.fully_connected(tuple(sorted(union))):
            keep, drop = (cu, cv) if cu < cv else (cv, cu)
            groups[keep] = union
            groups[drop] = set()
            for d in union:
                of[d] = keep

    return [tuple(sorted(g)) for g in groups if g]


# ---------------------------------------------------------------------------
# Alg. 3 lines 2-3 — recursive weakest-edge splitting
# ---------------------------------------------------------------------------
def split_oversized(
    group: tuple[int, ...], omega: int, view: _CrmView
) -> list[tuple[int, ...]]:
    """Recursively split ``group`` until every part has size <= omega."""
    if len(group) <= omega:
        return [group]
    best: tuple[float, int, int] | None = None
    for i in range(len(group)):
        for j in range(i + 1, len(group)):
            w = view.weight(group[i], group[j])
            if best is None or w < best[0]:
                best = (w, group[i], group[j])
    assert best is not None
    _, u, v = best
    a, b = split_clique_on_edge(group, u, v, view)
    return split_oversized(a, omega, view) + split_oversized(b, omega, view)


# ---------------------------------------------------------------------------
# Alg. 3 lines 4-10 — approximate merging via full rescans
# ---------------------------------------------------------------------------
def hot_membership(
    groups: list[tuple[int, ...]], view: _CrmView
) -> np.ndarray:
    """(k, h) 0/1 membership matrix restricted to the hot index space."""
    h = view._norm.shape[0]
    M = np.zeros((len(groups), h), dtype=np.float32)
    for i, g in enumerate(groups):
        idx = view._lut[list(g)]
        idx = idx[idx >= 0]
        M[i, idx] = 1.0
    return M


def merge_scores(
    groups: list[tuple[int, ...]],
    view: _CrmView,
    omega: int,
    pair_edges=None,
) -> np.ndarray:
    """Density of every pairwise union with |U| == omega; -1 elsewhere."""
    k = len(groups)
    M = hot_membership(groups, view)
    A = view._bin.astype(np.float32)
    if pair_edges is None:
        X = M @ A @ M.T
    else:
        X = np.asarray(pair_edges(M, A))
    within = np.diag(X) / 2.0
    e_u = within[:, None] + within[None, :] + X
    sizes = np.array([len(g) for g in groups], dtype=np.int64)
    ok = (sizes[:, None] + sizes[None, :]) == omega
    np.fill_diagonal(ok, False)
    e_max = omega * (omega - 1) / 2.0
    dens = np.where(ok, e_u / e_max, -1.0).astype(np.float32)
    assert dens.shape == (k, k)
    return dens


def _mergeable_split(
    groups: list[tuple[int, ...]], view: _CrmView, omega: int, gamma: float
) -> tuple[list[tuple[int, ...]], list[tuple[int, ...]]]:
    """Split groups into (merge candidates, pass-through).

    A group with no hot member has zero CRM edges; for
    gamma > (omega-2)/omega it can never reach the density bar and is
    excluded from the O(k^2) scan (exact pruning).
    """
    if omega <= 2 or gamma <= (omega - 2) / omega:
        return list(groups), []
    cand, rest = [], []
    for g in groups:
        if any(view._lut[d] >= 0 for d in g):
            cand.append(g)
        else:
            rest.append(g)
    return cand, rest


def approximate_merge(
    groups: list[tuple[int, ...]],
    view: _CrmView,
    omega: int,
    gamma: float,
    pair_edges=None,
) -> list[tuple[int, ...]]:
    """Greedy best-density-first merging, one full rescan per merge."""
    cand, rest = _mergeable_split(list(groups), view, omega, gamma)
    while len(cand) >= 2:
        dens = merge_scores(cand, view, omega, pair_edges=pair_edges)
        dens = np.where(dens >= gamma, dens, -1.0)
        if dens.max() < 0:
            break
        i, j = np.unravel_index(int(np.argmax(dens)), dens.shape)
        if i > j:
            i, j = j, i
        merged = tuple(sorted(cand[i] + cand[j]))
        cand = [g for t, g in enumerate(cand) if t not in (i, j)]
        cand.append(merged)
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
    """One clique-generation event: adjust -> split -> approximate-merge."""
    view = _CrmView(crm, n)
    if prev is None:
        prev = CliquePartition.singletons(n)
    added, removed = edge_diff(prev_crm, crm)
    groups = adjust_previous_cliques(prev, added, removed, view, omega)
    if enable_split:
        out: list[tuple[int, ...]] = []
        for g in groups:
            out.extend(split_oversized(g, omega, view))
    else:
        out = list(groups)
    if enable_approx_merge:
        out = approximate_merge(out, view, omega, gamma, pair_edges=pair_edges)
    return CliquePartition.from_cliques(n, out)
