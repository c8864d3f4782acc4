"""Trace container + batching/windowing utilities (paper §III.B, Fig. 3); a
copy of ``repro.traces.loader``.

A trace is a time-sorted sequence of requests r_i = <D_i, s_j, t_i>:

* ``times``   (R,)        float64, non-decreasing
* ``servers`` (R,)        int32 in [0, m)
* ``items``   (R, d_max)  int32 item ids, -1 padded (D_i as a set)

The port keeps its own copy so it never imports the JAX package; arrays
stay host numpy (the replay moves them to the device itself).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Trace:
    times: np.ndarray
    servers: np.ndarray
    items: np.ndarray
    n: int                      # catalog size |U|
    m: int                      # number of servers |S|
    name: str = "trace"
    sizes: np.ndarray | None = None   # (n,) per-item sizes; None = unit items

    def __post_init__(self):
        # real ValueErrors, not asserts: asserts vanish under `python -O`,
        # silently letting malformed traces through in optimized runs
        R = self.times.shape[0]
        if self.servers.shape != (R,):
            raise ValueError(
                f"servers must have shape ({R},), got {self.servers.shape}")
        if self.items.ndim != 2 or self.items.shape[0] != R:
            raise ValueError(
                f"items must have shape ({R}, d_max), got {self.items.shape}")
        if not (np.diff(self.times) >= 0).all():
            raise ValueError("trace must be time-sorted (non-decreasing times)")
        if self.sizes is not None:
            s = np.asarray(self.sizes, dtype=np.float64)
            if s.shape != (self.n,):
                raise ValueError(
                    f"sizes must have shape ({self.n},), got {s.shape}")
            if not np.all(np.isfinite(s)) or (s <= 0).any():
                raise ValueError("sizes must be finite and positive")
            object.__setattr__(self, "sizes", s)

    @property
    def n_requests(self) -> int:
        return int(self.times.shape[0])

    @property
    def d_max(self) -> int:
        return int(self.items.shape[1])

    def slice(self, start: int, stop: int) -> "Trace":
        return Trace(
            times=self.times[start:stop],
            servers=self.servers[start:stop],
            items=self.items[start:stop],
            n=self.n,
            m=self.m,
            name=self.name,
            sizes=self.sizes,
        )

    def head(self, k: int) -> "Trace":
        return self.slice(0, min(k, self.n_requests))

    def request_sizes(self) -> np.ndarray:
        return (self.items >= 0).sum(axis=1)

    def item_frequencies(self) -> np.ndarray:
        flat = self.items[self.items >= 0]
        return np.bincount(flat, minlength=self.n)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            times=self.times,
            servers=self.servers,
            items=self.items,
            n=self.n,
            m=self.m,
            name=self.name,
            # npz cannot hold None: unit-size traces save an empty array
            sizes=self.sizes if self.sizes is not None else np.zeros(0),
        )

    @classmethod
    def load(cls, path: str) -> "Trace":
        z = np.load(path, allow_pickle=False)
        sizes = None
        if "sizes" in z.files and z["sizes"].size:     # pre-sizes npz compat
            sizes = z["sizes"]
        return cls(
            times=z["times"],
            servers=z["servers"],
            items=z["items"],
            n=int(z["n"]),
            m=int(z["m"]),
            name=str(z["name"]),
            sizes=sizes,
        )


def iter_batches(trace: Trace, batch_size: int) -> Iterator[Trace]:
    """Consecutive request batches (paper batch size: 200)."""
    for s in range(0, trace.n_requests, batch_size):
        yield trace.slice(s, s + batch_size)


@dataclasses.dataclass(frozen=True)
class TraceBatches:
    """Dense padded batch tensors of a trace, ready for the batched engine.

    * ``times``   (nb, B) float64, tail padded with the trace's last time
    * ``servers`` (nb, B) int32,   tail padded with 0
    * ``items``   (nb, B, d_max) int32, tail padded with all -1 rows (the
      engine treats all--1 rows as empty requests producing no events)
    * ``lengths`` (nb,) int32 valid request count per batch (< B only in the
      final batch)
    """

    times: np.ndarray
    servers: np.ndarray
    items: np.ndarray
    lengths: np.ndarray
    n: int
    m: int
    name: str = "trace"

    @property
    def n_batches(self) -> int:
        return int(self.times.shape[0])

    @property
    def batch_size(self) -> int:
        return int(self.times.shape[1])

    @property
    def n_requests(self) -> int:
        return int(self.lengths.sum())


def batch_tensors(trace: Trace, batch_size: int) -> TraceBatches:
    """Pad and reshape a trace into (n_batches, batch_size, ...) tensors."""
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    R, B, d = trace.n_requests, batch_size, trace.d_max
    nb = max(1, -(-R // B))
    pad = nb * B - R
    t_pad = float(trace.times[-1]) if R else 0.0
    times = np.concatenate(
        [trace.times, np.full(pad, t_pad, dtype=np.float64)]
    ).reshape(nb, B)
    servers = np.concatenate(
        [trace.servers, np.zeros(pad, dtype=np.int32)]
    ).reshape(nb, B)
    items = np.concatenate(
        [trace.items, np.full((pad, d), -1, dtype=np.int32)]
    ).reshape(nb, B, d)
    lengths = np.full(nb, B, dtype=np.int32)
    lengths[-1] = B - pad
    return TraceBatches(
        times=times, servers=servers, items=items, lengths=lengths,
        n=trace.n, m=trace.m, name=trace.name,
    )


def iter_batch_tensors(
    trace: Trace, batch_size: int
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Yield (times, servers, items, length) padded batch tensors."""
    tb = batch_tensors(trace, batch_size)
    for b in range(tb.n_batches):
        yield tb.times[b], tb.servers[b], tb.items[b], int(tb.lengths[b])


def iter_windows(trace: Trace, t_cg: float) -> Iterator[tuple[float, Trace]]:
    """(window_end_time, window_trace) pairs on the T_CG grid (Fig. 3)."""
    if trace.n_requests == 0:
        return
    t0 = float(trace.times[0])
    edges = np.arange(t0, float(trace.times[-1]) + t_cg, t_cg)
    idx = np.searchsorted(trace.times, edges[1:], side="left")
    prev = 0
    for e, i in zip(edges[1:], idx):
        if i > prev:
            yield float(e), trace.slice(prev, i)
        prev = i
    if prev < trace.n_requests:
        yield float(trace.times[-1]) + t_cg, trace.slice(prev, trace.n_requests)
