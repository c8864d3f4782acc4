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

``row_sharded``
    The dense geometry with rows padded to a multiple of the shard count,
    ``(round_up(n + 1, k), m)`` with the dump row last, and, on a
    :class:`~repro_torch.launch.mesh.SweepMesh` with a ``"state_row"``
    axis, the rows split into k blocks over that axis's devices
    (:class:`~repro_torch.core.sharded_state.RowShardedState`): for
    catalogs one card cannot hold.  Without a mesh (``shards=k`` alone)
    only the geometry applies, on one device.  The scan is unchanged: its
    row gathers and scatters go to the block that owns each row, where
    the reference lets GSPMD partition them.

The layout owns the state dims, the dump-row index and the placement;
host-side :class:`~repro_torch.core.engine.CacheState` stays dense ``(k,
m)`` under every layout, which is what makes snapshots portable between
layouts (and with the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Any

LAYOUT_KINDS = ("dense", "bucketed", "row_sharded")


def _round_up(x: int, step: int) -> int:
    return -(-int(x) // int(step)) * int(step)


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Geometry and placement of the device cache state.

    ``row_bucket`` / ``col_bucket`` are the bucket steps of ``bucketed``
    (catalog rows round up to ``row_bucket`` multiples, server columns to
    ``col_bucket``); the other kinds ignore them.  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.SweepMesh` carrying ``row_axis``)
    places a ``row_sharded`` state; ``shards`` is the row-shard count
    (default: the mesh's ``row_axis`` size, 1 without a mesh).
    """

    kind: str = "dense"
    row_bucket: int = 1024
    col_bucket: int = 256
    mesh: Any = None
    shards: int | None = None
    row_axis: str = "state_row"

    def __post_init__(self):
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(
                f"unknown state layout {self.kind!r}; choose from "
                f"{LAYOUT_KINDS}")
        if self.row_bucket < 1 or self.col_bucket < 1:
            raise ValueError("bucket steps must be >= 1")
        if self.kind == "row_sharded":
            if self.row_shards < 1:
                raise ValueError("row_sharded layout needs shards >= 1")
            axis = self._mesh_rows()
            if axis and self.shards is not None and self.shards != axis:
                raise ValueError(
                    f"shards={self.shards} but the mesh's {self.row_axis!r} "
                    f"axis has {axis} device(s): one block a device")

    @classmethod
    def resolve(cls, layout) -> "StateLayout":
        """None -> dense; str -> the default layout of that kind; a
        StateLayout passes through.  ``"row_sharded"`` alone names no
        shard count, so it raises."""
        if layout is None:
            return DENSE
        if isinstance(layout, str):
            if layout == "row_sharded":
                raise ValueError(
                    "row_sharded needs a mesh (or explicit shards); "
                    "construct StateLayout(kind='row_sharded', mesh=...)")
            return cls(kind=layout)
        if not isinstance(layout, StateLayout):
            raise TypeError(f"not a StateLayout: {layout!r}")
        return layout

    def _mesh_rows(self) -> int:
        """The mesh's ``row_axis`` size (0 without a mesh or that axis)."""
        if self.mesh is None or self.row_axis not in self.mesh.axis_names:
            return 0
        return int(self.mesh.shape[self.row_axis])

    @property
    def row_shards(self) -> int:
        """Number of row shards (1 for dense and bucketed)."""
        if self.kind != "row_sharded":
            return 1
        if self.shards is not None:
            return int(self.shards)
        return self._mesh_rows() or 1

    @property
    def places_rows(self) -> bool:
        """True iff the state rows go to blocks on the mesh's devices (a
        ``row_sharded`` layout whose mesh has a ``row_axis`` of more than
        one device); otherwise the state is one tensor on one device."""
        return self.kind == "row_sharded" and self._mesh_rows() > 1

    def state_rows(self, n: int) -> int:
        """Device state rows INCLUDING the dump row (always the last)."""
        if self.kind == "bucketed":
            return _round_up(max(n, 1), self.row_bucket) + 1
        if self.kind == "row_sharded":
            return _round_up(n + 1, self.row_shards)
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
        """True iff this layout gives the dense geometry at (n, m) on one
        shard."""
        return self.row_shards == 1 and self.state_dims(n, m) == (n + 1, m)

    def supports_device_cgm(self, n: int, m: int) -> bool:
        """The device clique generation keeps a dense-n carry of its own
        whatever the layout, so every single-shard layout admits it; rows
        split over shards do not (its in-scan reductions need every slot
        on one device)."""
        del n, m
        return self.row_shards == 1

    def state_bytes(self, n: int, m: int) -> int:
        """Device bytes of one scenario's state (f64 E + i32 anchor), the
        reference's count."""
        rows, cols = self.state_dims(n, m)
        return rows * cols * 8 + rows * 4

    def state_bytes_per_device(self, n: int, m: int) -> int:
        """Per-device state bytes (row_sharded splits the rows evenly)."""
        return self.state_bytes(n, m) // self.row_shards

    def place_state(self, E, anchor, *, block: int = 0):
        """``(E, anchor)`` (host numpy or tensors, rows on the
        second-to-last axis of ``E``, an optional leading lane axis) in
        this layout's placement: the views of a
        :class:`~repro_torch.core.sharded_state.RowShardedState` whose
        blocks sit on lane block ``block``'s ``row_axis`` devices, or the
        inputs unchanged unless the layout spans more than one device."""
        if not self.places_rows:
            return E, anchor
        from .sharded_state import RowShardedState

        st = RowShardedState.from_dense(
            E, anchor, self.mesh.row_devices(block))
        return st.E, st.anchor

    @property
    def tag(self) -> str:
        """The snapshot's layout tag."""
        return self.kind

    def check_restore(self, snap_tag: str, snap_shards: int) -> None:
        """The reference's restore rule: host state is dense under every
        layout, so any snapshot restores into a dense or bucketed session;
        a row-sharded snapshot restored into a row-sharded session must
        match its shard count."""
        if snap_tag not in LAYOUT_KINDS:
            raise ValueError(
                f"snapshot has an unknown state layout {snap_tag!r}")
        if snap_tag == "row_sharded" and self.kind == "row_sharded" \
                and int(snap_shards) != self.row_shards:
            raise ValueError(
                f"snapshot state layout is row_sharded over {snap_shards} "
                f"shard(s), session mesh has {self.row_shards}; restore "
                "on a matching mesh (or a dense/bucketed session)")


#: the layout every ``layout=None`` resolves to
DENSE = StateLayout()
