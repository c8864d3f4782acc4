"""Normalised co-access correlation matrix (paper Alg. 2), host half.

A copy of the parts of ``repro.core.crm`` the device clique generation
needs on the host: the :class:`WindowCRM` container (the AKPC policy's
previous-window CRM, which seeds the Alg.-4 edge diff of the next
boundary) and the hot-set rule.  The CRM itself is built on the device
(:mod:`repro_torch.core.cgm`, kernel ``crm_update``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
