"""Disjoint clique partitions of the catalog (paper §III.C).

A copy of ``repro.core.cliques.CliquePartition``: every item belongs to
exactly one clique (singleton by default), so a clique set is a partition
of [0, n) and the cache state is a dense (k, m) expiry matrix.  The clique
generation itself runs on the device (:mod:`repro_torch.core.cgm`).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np


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
