"""Device state layouts of the replay (port of ``repro.core.state_layout``).

The replay keeps the cache state as a float64 expiry matrix ``E`` plus an
int anchor vector on the device: one row per possible clique id and a
dump row (always the LAST row) that absorbs masked scatter writes.

``dense``
    ``(n + 1, m)``, the default every ``layout=None`` resolves to.

``bucketed``
    Rows (catalog) and columns (servers) round UP to padding buckets: the
    state is ``(bucket(n) + 1, bucket(m))`` with the dump row last.  Points
    whose (n, m) fall in the same bucket have the same state geometry, so
    a mixed-shape sweep replays each bucket COHORT as the lanes of one
    scan.  Padded rows and columns are inert: real events never gather a
    row above the live prefix, event scatters only touch servers below m
    and install seeding only targets real servers, so padded columns hold
    zeros forever.

``row_sharded`` (state rows over a device mesh) is refused: it waits for
the port's mesh (ROADMAP queue 1, item 5).

The layout owns the state dims and the dump-row index; host-side
:class:`~repro_torch.core.engine.CacheState` stays dense ``(k, m)`` under
every layout, which is what makes snapshots portable between dense and
bucketed sessions (and with the reference's).
"""
from __future__ import annotations

import dataclasses

LAYOUT_KINDS = ("dense", "bucketed", "row_sharded")


def _round_up(x: int, step: int) -> int:
    return -(-int(x) // int(step)) * int(step)


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Geometry of the device cache state.

    ``row_bucket`` / ``col_bucket`` are the bucket steps of ``bucketed``
    (catalog rows round up to ``row_bucket`` multiples, server columns to
    ``col_bucket``); the dense kind ignores them.
    """

    kind: str = "dense"
    row_bucket: int = 1024
    col_bucket: int = 256

    def __post_init__(self):
        if self.kind == "row_sharded":
            raise NotImplementedError(
                "state layout 'row_sharded' is not ported yet (ROADMAP "
                "queue 1, item 5: the mesh); the port runs the dense and "
                "bucketed layouts")
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(
                f"unknown state layout {self.kind!r}; choose from "
                f"{LAYOUT_KINDS}")
        if self.row_bucket < 1 or self.col_bucket < 1:
            raise ValueError("bucket steps must be >= 1")

    @classmethod
    def resolve(cls, layout) -> "StateLayout":
        """None -> dense; str -> the default layout of that kind; a
        StateLayout passes through."""
        if layout is None:
            return DENSE
        if isinstance(layout, str):
            return cls(kind=layout)
        if not isinstance(layout, StateLayout):
            raise TypeError(f"not a StateLayout: {layout!r}")
        return layout

    @property
    def row_shards(self) -> int:
        """Number of row shards (1 for both kinds the port runs)."""
        return 1

    def state_rows(self, n: int) -> int:
        """Device state rows INCLUDING the dump row (always the last)."""
        if self.kind == "bucketed":
            return _round_up(max(n, 1), self.row_bucket) + 1
        return n + 1

    def state_cols(self, m: int) -> int:
        if self.kind == "bucketed":
            return _round_up(max(m, 1), self.col_bucket)
        return m

    def state_dims(self, n: int, m: int) -> tuple[int, int]:
        """(rows, cols) of the device expiry matrix for an (n, m) catalog."""
        return self.state_rows(n), self.state_cols(m)

    def dump_row(self, n: int) -> int:
        """Index of the masked-scatter dump row (always rows - 1)."""
        return self.state_rows(n) - 1

    def is_dense_for(self, n: int, m: int) -> bool:
        """True iff this layout gives the dense geometry at (n, m)."""
        return self.state_dims(n, m) == (n + 1, m)

    def supports_device_cgm(self, n: int, m: int) -> bool:
        """The device clique generation keeps a dense-n carry of its own
        whatever the layout, so every single-shard layout admits it."""
        del n, m
        return self.row_shards == 1

    def state_bytes(self, n: int, m: int) -> int:
        """Device bytes of one scenario's state (f64 E + i32 anchor)."""
        rows, cols = self.state_dims(n, m)
        return rows * cols * 8 + rows * 4

    @property
    def tag(self) -> str:
        """The snapshot's layout tag."""
        return self.kind

    def check_restore(self, snap_tag: str, snap_shards: int) -> None:
        """The reference's restore rule: dense and bucketed snapshots (and
        a row-sharded one, whose host state is dense too) restore freely
        into a dense or bucketed session; only a row-sharded session
        checks the shard count, and the port has none."""
        if snap_tag not in LAYOUT_KINDS:
            raise ValueError(
                f"snapshot has an unknown state layout {snap_tag!r}")
        del snap_shards


#: the layout every ``layout=None`` resolves to
DENSE = StateLayout()
