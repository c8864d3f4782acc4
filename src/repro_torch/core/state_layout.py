"""Device state layout of the replay (the dense kind of ``repro.core.state_layout``).

The replay keeps the cache state as an ``(n + 1, m)`` float64 expiry
matrix plus an ``(n + 1,)`` int32 anchor vector on the device: one row per
possible clique id and a dump row (the last) that absorbs masked scatter
writes.  This port carries only that ``dense`` geometry; the ``bucketed``
and ``row_sharded`` kinds of the reference raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

LAYOUT_KINDS = ("dense",)


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Geometry of the device cache state (dense only)."""

    kind: str = "dense"

    def __post_init__(self):
        if self.kind in ("bucketed", "row_sharded"):
            raise NotImplementedError(
                f"state layout {self.kind!r} is not ported yet; the port "
                "runs the dense layout only")
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(
                f"unknown state layout {self.kind!r}; choose from "
                f"{LAYOUT_KINDS}")

    @classmethod
    def resolve(cls, layout) -> "StateLayout":
        """None -> dense; str -> that kind; a StateLayout passes through."""
        if layout is None:
            return DENSE
        if isinstance(layout, str):
            return cls(kind=layout)
        if not isinstance(layout, StateLayout):
            raise TypeError(f"not a StateLayout: {layout!r}")
        return layout

    def state_rows(self, n: int) -> int:
        """Device state rows INCLUDING the dump row (always the last)."""
        return n + 1

    def state_cols(self, m: int) -> int:
        return m

    def state_dims(self, n: int, m: int) -> tuple[int, int]:
        """(rows, cols) of the device expiry matrix for an (n, m) catalog."""
        return self.state_rows(n), self.state_cols(m)

    def dump_row(self, n: int) -> int:
        return self.state_rows(n) - 1

    def supports_device_cgm(self, n: int, m: int) -> bool:
        """The device clique generation needs the whole slot map on one
        device, which the dense layout always gives."""
        del n, m
        return True

    def state_bytes(self, n: int, m: int) -> int:
        """Device bytes of the state (f64 E + i32 anchor)."""
        rows, cols = self.state_dims(n, m)
        return rows * cols * 8 + rows * 4


#: the layout every ``layout=None`` resolves to
DENSE = StateLayout()
