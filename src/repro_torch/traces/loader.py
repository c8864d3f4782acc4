"""Trace container (paper §III.B, Fig. 3); a copy of ``repro.traces.loader``.

A trace is a time-sorted sequence of requests r_i = <D_i, s_j, t_i>:

* ``times``   (R,)        float64, non-decreasing
* ``servers`` (R,)        int32 in [0, m)
* ``items``   (R, d_max)  int32 item ids, -1 padded (D_i as a set)

The port keeps its own copy so it never imports the JAX package; arrays
stay host numpy (the replay moves them to the device itself).
"""
from __future__ import annotations

import dataclasses

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

