"""Normalised co-access correlation matrix (paper Alg. 2), on the host.

A copy of ``repro.core.crm``: the :class:`WindowCRM` container (the AKPC
policy's previous-window CRM, which seeds the Alg.-4 edge diff of the
next boundary), the hot-set rule, and Alg. 2 itself for the host clique
generation (:func:`build_window_crm`).  Counting co-occurrences is
``H^T H`` with H the one-hot request/item incidence: the ``crm_matmul``
hook runs that product on the card (kernel ``crm_update``, wired by
:mod:`repro_torch.kernels.autowire`, which builds H there from the hot
id lists); without a hook the numpy pair scatter gives the same counts.
The device clique generation (:mod:`repro_torch.core.cgm`) builds its
CRM on the card instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..spans import span

#: padded-row width above which the pairwise scatter would materialise more
#: index pairs than the dense incidence product it replaces
_SCATTER_MAX_WIDTH = 128


@dataclasses.dataclass(frozen=True)
class WindowCRM:
    """CRM of one window restricted to that window's hot items."""

    hot_items: np.ndarray       # (h,) int32 global item ids, sorted
    raw: np.ndarray             # (h, h) int64 co-occurrence counts
    norm: np.ndarray            # (h, h) float32 min-max normalised
    binary: np.ndarray          # (h, h) bool   norm > theta

    @property
    def n_hot(self) -> int:
        return int(self.hot_items.shape[0])

    @classmethod
    def from_compact(cls, p_idx, raw, norm, binary, *, n: int) -> "WindowCRM":
        """Device compact carry -> host ``WindowCRM``.

        ``p_idx`` is the padded (h,) hot->catalog index map (ascending
        real ids first, pads = n); ``raw``/``norm``/``binary`` are the
        (h, h) workspace matrices.  The device keeps pad rows/cols zeroed,
        so the leading (nh, nh) block IS the host hot-space CRM (raw
        counts are exact f32 integers, restored to int64 here).
        """
        p_idx = np.asarray(p_idx)
        nh = int((p_idx < n).sum())
        return cls(
            hot_items=p_idx[:nh].astype(np.int32),
            raw=np.asarray(raw)[:nh, :nh].astype(np.int64),
            norm=np.asarray(norm)[:nh, :nh].astype(np.float32),
            binary=np.asarray(binary)[:nh, :nh].astype(bool),
        )


def hot_items_of_window(
    items: np.ndarray, n: int, top_frac: float, top_frac_of: str = "window"
) -> np.ndarray:
    """ids of the ``top_frac`` most frequently accessed items of the window.

    ``top_frac_of="window"`` (default, paper §V.A) takes the fraction over
    the window's distinct accessed items; ``"catalog"`` takes it of n.
    Ties in the count go to the lower id (stable sort); never-accessed
    items are never hot.
    """
    if top_frac_of not in ("window", "catalog"):
        raise ValueError(
            f"top_frac_of must be 'window' or 'catalog', got {top_frac_of!r}"
        )
    flat = items[items >= 0]
    counts = np.bincount(flat, minlength=n)
    base = n if top_frac_of == "catalog" else int((counts > 0).sum())
    n_hot = max(1, int(round(base * top_frac)))
    order = np.argsort(-counts, kind="stable")
    hot = order[:n_hot]
    hot = hot[counts[hot] > 0]
    return np.sort(hot).astype(np.int32)


def incidence_matrix(items: np.ndarray, n: int) -> np.ndarray:
    """One-hot request/item incidence H (B, n) from padded item ids.

    ``items``: (B, d_max) int32, padded with -1.
    """
    B = items.shape[0]
    H = np.zeros((B, n), dtype=np.float32)
    req_idx, col = np.nonzero(items >= 0)
    H[req_idx, items[req_idx, col]] = 1.0
    return H


def cooccurrence_counts(items: np.ndarray, n: int) -> np.ndarray:
    """Raw CRM(W): symmetric co-occurrence counts with zero diagonal.

    Alg. 2 lines 1-4: for every request, every unordered item pair
    increments both symmetric entries once.  Counts come from a unique-key
    reduction over the window's (request-deduplicated) item pairs, the
    sparse equivalent of ``H^T @ H`` with 0/1 incidence.
    """
    items = np.asarray(items)
    crm = np.zeros((n, n), dtype=np.int64)
    if items.ndim != 2 or 0 in items.shape:
        return crm
    B, d = items.shape
    if d > _SCATTER_MAX_WIDTH or B * n * n <= (1 << 25):
        # wide rows, or an index space so small the dense product is cheaper
        # than sorting the window
        H = incidence_matrix(items, n)
        crm[...] = (H.T @ H).astype(np.int64)
        np.fill_diagonal(crm, 0)
        return crm
    # incidence is 0/1: an item repeated inside one request counts once
    s = np.sort(items, axis=1)
    dup = s[:, 1:] == s[:, :-1]
    if dup.any():
        s[:, 1:][dup] = -1
        s = np.sort(s, axis=1)          # re-pack valid ids into the tail
    c = (s >= 0).sum(axis=1)            # distinct items per request
    key_parts = []
    for cc in np.unique(c):             # group rows by cardinality: the pair
        if cc < 2:                      # grid is sum(c_r^2), not B * d^2
            continue
        rows = s[c == cc, d - cc:].astype(np.int64)
        ii, jj = np.nonzero(~np.eye(cc, dtype=bool))
        key_parts.append((rows[:, ii] * n + rows[:, jj]).ravel())
    if key_parts:
        keys = np.concatenate(key_parts)
        if n * n <= (1 << 22):          # count in place: O(keys + n^2)
            crm.reshape(-1)[:] = np.bincount(keys, minlength=n * n)
        else:
            uk, uc = np.unique(keys, return_counts=True)
            crm.reshape(-1)[uk] = uc
    return crm


def minmax_normalise(crm: np.ndarray) -> np.ndarray:
    """Min-max scaling to [0, 1] (Alg. 2 line 5)."""
    lo = crm.min()
    hi = crm.max()
    if hi <= lo:
        return np.zeros_like(crm, dtype=np.float32)
    if lo == 0:                         # the common case: skip the subtract
        return (crm / hi).astype(np.float32)
    return ((crm - lo) / (hi - lo)).astype(np.float32)


def build_window_crm(
    items: np.ndarray,
    n: int,
    theta: float,
    top_frac: float = 0.1,
    crm_matmul=None,
    top_frac_of: str = "window",
) -> WindowCRM:
    """Alg. 2 end to end for one window.

    ``crm_matmul``: optional ``(H) -> H^T H`` on the card (the
    ``crm_update`` hook); defaults to the numpy pair scatter.  A hook with
    a ``from_ids(compact, h)`` entry gets the (B, d) int32 hot-remapped
    ids instead of a host ``H`` (the autowired one builds ``H`` on the
    card).
    ``top_frac_of``: hot-set denominator, see :func:`hot_items_of_window`.
    """
    hot = hot_items_of_window(items, n, top_frac, top_frac_of)
    h = hot.shape[0]
    # remap window items into the compact hot index space; cold items -> -1
    lut = np.full(n, -1, dtype=np.int32)
    lut[hot] = np.arange(h, dtype=np.int32)
    compact = np.where(items >= 0, lut[np.clip(items, 0, n - 1)], -1)
    if crm_matmul is None:
        raw = cooccurrence_counts(compact, h)
    else:
        from_ids = getattr(crm_matmul, "from_ids", None)
        if from_ids is not None:        # H built where the hook runs
            counts = from_ids(compact, h)
        else:
            with span("host_cgm.incidence"):
                H = incidence_matrix(compact, h)
            counts = crm_matmul(H)
        raw = np.asarray(counts).astype(np.int64)
        np.fill_diagonal(raw, 0)
    norm = minmax_normalise(raw)
    binary = norm > theta
    np.fill_diagonal(binary, False)
    return WindowCRM(hot_items=hot, raw=raw, norm=norm, binary=binary)


def edge_diff_arrays(
    prev: WindowCRM | None, cur: WindowCRM
) -> tuple[np.ndarray, np.ndarray]:
    """Delta-E between consecutive binary CRMs as (e, 2) int64 arrays.

    Boolean-matrix diff over the union hot index space (Alg. 4 input):
    rows are (global_u, global_v) with u < v, lexicographically sorted.
    """
    if prev is None:
        iu, iv = np.nonzero(np.triu(cur.binary, k=1))
        added = np.stack(
            [cur.hot_items[iu], cur.hot_items[iv]], axis=1
        ).astype(np.int64)
        return added, np.zeros((0, 2), dtype=np.int64)
    union = np.union1d(prev.hot_items, cur.hot_items)
    U = union.shape[0]
    P = np.zeros((U, U), dtype=bool)
    C = np.zeros((U, U), dtype=bool)
    pi = np.searchsorted(union, prev.hot_items)
    ci = np.searchsorted(union, cur.hot_items)
    P[np.ix_(pi, pi)] = prev.binary
    C[np.ix_(ci, ci)] = cur.binary
    au, av = np.nonzero(np.triu(C & ~P, k=1))
    ru, rv = np.nonzero(np.triu(P & ~C, k=1))
    added = np.stack([union[au], union[av]], axis=1).astype(np.int64)
    removed = np.stack([union[ru], union[rv]], axis=1).astype(np.int64)
    return added, removed
