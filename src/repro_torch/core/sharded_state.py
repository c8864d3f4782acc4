"""Row-sharded replay state: ``E`` and ``anchor`` split into row blocks
over the devices of a mesh's ``"state_row"`` axis (the ``row_sharded``
:class:`~repro_torch.core.state_layout.StateLayout`).

The reference places the state rows with a ``NamedSharding`` and lets
GSPMD partition the scan's row-indexed gathers and scatters.  Here a
:class:`RowShardedState` holds k blocks of R = rows / k rows each, block b
on device b of the lane block's ``state_row`` devices (which may repeat a
device: logical shards), and the replay scan reaches them through
:func:`take_rows` / :func:`put_rows`, which route every index to the block
that owns it:

* a take gathers from every block at the index clamped into the block,
  moves each result to the home device and keeps, index by index, the
  owner's value (``torch.where``, no arithmetic on the values): the
  result is the dense gather's, bit for bit, in input order;
* a put writes each block at the indices it owns and sends the others to
  the block's SCRATCH row, one row past its R rows that nothing reads:
  the sharded counterpart of the dump row.  A put's result is the dense
  put's wherever the dense put is determined (indices repeat only at the
  dump row, the global last row, which lives in the last block).

Both work on row indices of the (lanes, rows, m) ``E`` and (lanes, rows)
``anchor``, and on flat ``row * m + col`` indices of ``E.view(lanes, rows
* m)``; the routing is integer arithmetic on the device (a floor division
by the block span), so the scan still makes no host sync.  Every take
and put of a scan reads or writes all k blocks; ``stats`` counts the
block accesses and the copies between distinct devices.

Blocks never move: an index or a value on another device than the home
one, or a block found off its mesh device, raises.
"""
from __future__ import annotations

import numpy as np
import torch


def take_rows(a, idx):
    """``a[:, idx]``: ``idx`` (n,) shared by the lanes, or (S, n) lane by
    lane; a 3-D ``a`` gives whole rows.  A :class:`ShardedRows` ``a``
    routes to its blocks."""
    if isinstance(a, ShardedRows):
        return a.take(idx)
    if idx.dim() == 1:
        return a[:, idx]
    if a.dim() == 3:
        idx = idx[..., None].expand(-1, -1, a.shape[2])
    return a.gather(1, idx)


def put_rows(a, idx, src) -> None:
    """``a[:, idx] = src`` in place, ``idx`` as :func:`take_rows` reads
    it."""
    if isinstance(a, ShardedRows):
        a.put(idx, src)
        return
    if idx.dim() == 1:
        a[:, idx] = src
        return
    if a.dim() == 3:
        idx = idx[..., None].expand(-1, -1, a.shape[2])
    a.scatter_(1, idx, src.expand(idx.shape))


def _on(t: torch.Tensor, device: torch.device, what: str) -> None:
    if t.device != device:
        raise RuntimeError(f"{what} is on {t.device}, not {device}: the "
                           "row-sharded state moves no block")


class ShardedRows:
    """One state tensor split into row blocks: the rows axis is axis
    ``lead`` (1 with a leading lane axis, else 0); block b holds global
    positions ``[b * span, (b + 1) * span)`` of that axis and one scratch
    position (a row, or a row's worth of flat positions) past them."""

    def __init__(self, blocks: list, span: int, home: torch.device,
                 lead: int, stats: dict):
        self.blocks = blocks
        self.span = int(span)
        self.home = home
        self.lead = lead
        self.stats = stats
        b0 = blocks[0]
        self._shape = torch.Size(
            (*b0.shape[:lead], self.span * len(blocks), *b0.shape[lead + 1:]))

    # -- the tensor surface the scan reads ---------------------------------
    @property
    def shape(self) -> torch.Size:
        return self._shape

    def dim(self) -> int:
        return len(self._shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.home

    def is_contiguous(self) -> bool:
        return all(b.is_contiguous() for b in self.blocks)

    def __getitem__(self, key):
        """``a[None]``: the unlaned state as one lane (views)."""
        if key is not None or self.lead:
            raise TypeError("a ShardedRows takes only [None] on an unlaned "
                            "state")
        return ShardedRows([b[None] for b in self.blocks], self.span,
                           self.home, 1, self.stats)

    def view(self, *shape):
        """The flat ``(lanes, rows * m)`` view of a laned ``(lanes, rows,
        m)`` state, the only view the scan takes."""
        if self.lead != 1 or self.dim() != 3 or tuple(shape) != (
                self._shape[0], self._shape[1] * self._shape[2]):
            raise ValueError(f"a ShardedRows {tuple(self._shape)} views "
                             f"only as its flat (lanes, rows * m), not "
                             f"{shape}")
        m = int(self._shape[2])
        return ShardedRows([b.view(b.shape[0], -1) for b in self.blocks],
                           self.span * m, self.home, 1, self.stats)

    # -- routed accesses ----------------------------------------------------
    def _count(self) -> None:
        """One routed access: a gather or scatter a block, and two copies
        (the index out, the values back or out) a block off the home
        device."""
        st = self.stats
        st["block_ops"] += len(self.blocks)
        st["device_copies"] += 2 * sum(
            b.device != self.home for b in self.blocks)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """The dense ``take_rows`` of this state, on the home device."""
        _on(idx, self.home, "a take's index")
        self._count()
        owner = idx // self.span
        trail = self.blocks[0].dim() - 2
        out = None
        for b, blk in enumerate(self.blocks):
            loc = (idx - b * self.span).clamp_(0, self.span - 1)
            got = take_rows(blk, loc.to(blk.device)).to(self.home)
            if out is None:
                out = got
                continue
            mine = owner == b
            out = torch.where(mine.view(*mine.shape, *(1,) * trail), got,
                              out)
        return out

    def put(self, idx: torch.Tensor, src: torch.Tensor) -> None:
        """The dense ``put_rows`` of this state: each block writes the
        indices it owns, the rest go to its scratch position."""
        _on(idx, self.home, "a put's index")
        _on(src, self.home, "a put's values")
        self._count()
        owner = idx // self.span
        for b, blk in enumerate(self.blocks):
            loc = torch.where(owner == b, idx - b * self.span, self.span)
            put_rows(blk, loc.to(blk.device), src.to(blk.device))

    # -- reads ------------------------------------------------------------
    def head(self, k: int) -> np.ndarray:
        """The first ``k`` global rows on the host (numpy), blocks
        assembled in order; padding rows, the dump row and the scratch rows
        past them are left out."""
        parts = []
        for b, blk in enumerate(self.blocks):
            hi = min(self.span, k - b * self.span)
            if hi <= 0:
                break
            parts.append(blk.narrow(self.lead, 0, hi).cpu().numpy())
        if not parts:
            return self.blocks[0].narrow(self.lead, 0, 0).cpu().numpy()
        return np.concatenate(parts, axis=self.lead)

    def to_dense(self) -> torch.Tensor:
        """The whole state as one tensor on the home device (scratch rows
        dropped)."""
        return torch.cat([blk.narrow(self.lead, 0, self.span).to(self.home)
                          for blk in self.blocks], dim=self.lead)


class RowShardedState:
    """``E`` (lanes, rows, m) f64 and ``anchor`` (lanes, rows) as k row
    blocks of ``rows / k`` rows (plus a scratch row each), block b on
    ``devices[b]``; the lanes' home device is ``devices[0]``.  ``E`` and
    ``anchor`` are :class:`ShardedRows` views that the replay scan takes
    in place of tensors; ``stats`` counts their block accesses."""

    def __init__(self, E_blocks: list, a_blocks: list, devices: list,
                 lead: int):
        from ..launch.mesh import canonical_device

        self.devices = [canonical_device(d) for d in devices]
        self.home = self.devices[0]
        for blk, ab, dev in zip(E_blocks, a_blocks, self.devices):
            _on(blk, dev, "an E block")
            _on(ab, dev, "an anchor block")
        self.stats = {"block_ops": 0, "device_copies": 0}
        R = int(E_blocks[0].shape[lead]) - 1
        self.E = ShardedRows(E_blocks, R, self.home, lead, self.stats)
        self.anchor = ShardedRows(a_blocks, R, self.home, lead, self.stats)

    @classmethod
    def from_dense(cls, E, anchor, devices: list, *,
                   lanes: int | None = None) -> "RowShardedState":
        """Split ``E`` (..., rows, m) and ``anchor`` (..., rows) (numpy or
        tensors; a leading lane axis or none) into ``len(devices)`` row
        blocks, each with a scratch row (zeros, anchor -1), placed on its
        device.  ``lanes`` expands an unlaned state to that many lanes on
        the devices.  ``rows`` must divide by the block count (the
        layout's geometry pads it so)."""
        from ..launch.mesh import canonical_device

        E = torch.as_tensor(E)
        anchor = torch.as_tensor(anchor)
        lead = E.dim() - 2
        if lead not in (0, 1) or anchor.dim() != lead + 1 or \
                anchor.shape[lead] != E.shape[lead]:
            raise ValueError(f"E {tuple(E.shape)} / anchor "
                             f"{tuple(anchor.shape)} are not a state")
        k = len(devices)
        rows = int(E.shape[lead])
        if rows % k:
            raise ValueError(f"{rows} state rows do not split into {k} "
                             "blocks; pad them with the row_sharded layout")
        R = rows // k
        E_blocks, a_blocks = [], []
        for b, dev in enumerate(devices):
            dev = canonical_device(dev)
            e = E.narrow(lead, b * R, R)
            a = anchor.narrow(lead, b * R, R)
            e = torch.cat([e, e.new_zeros((*e.shape[:lead], 1,
                                           *e.shape[lead + 1:]))], dim=lead)
            a = torch.cat([a, a.new_full((*a.shape[:lead], 1), -1)],
                          dim=lead)
            e, a = e.to(dev), a.to(dev)
            if lanes is not None:
                if lead:
                    raise ValueError("lanes= expands an unlaned state")
                e = e[None].expand(lanes, -1, -1).contiguous()
                a = a[None].expand(lanes, -1).contiguous()
            E_blocks.append(e)
            a_blocks.append(a)
        return cls(E_blocks, a_blocks, devices,
                   1 if lanes is not None else lead)

    def to_dense(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(E, anchor)`` as single tensors on the home device."""
        return self.E.to_dense(), self.anchor.to_dense()
