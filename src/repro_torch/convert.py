"""Carry a reference run's data and state into the port, from plain arrays.

Data and state take the place of weights here: a trace, the cache state
of a replay engine, and a policy's window state (the AKPC policy's
partition and previous-window CRM, the TTL policy's keep-or-not mask).
Every function takes plain numpy arrays (read off ``repro``'s objects by
the caller), so the port never imports ``repro``.
"""
from __future__ import annotations

import numpy as np

from .core.cgm_schedule import partition_from_of
from .core.crm import WindowCRM
from .core.engine import CacheState
from .traces.loader import Trace


def trace_from_arrays(items, servers, times, n: int, m: int,
                      sizes=None, name: str = "trace") -> Trace:
    """A port :class:`Trace` from (R, d) items, (R,) servers and times."""
    return Trace(
        times=np.asarray(times, np.float64),
        servers=np.asarray(servers, np.int32),
        items=np.asarray(items, np.int32),
        n=int(n), m=int(m), name=name,
        sizes=None if sizes is None else np.asarray(sizes, np.float64),
    )


def state_from_arrays(clique_of, E, anchor, m: int) -> CacheState:
    """A port :class:`CacheState` from a partition's ``clique_of`` (n,)
    and the (k, m) expiries and (k,) anchors of its cliques.

    Clique ``g`` is the ascending list of items with ``clique_of == g``,
    which is how both packages order a partition's cliques.
    """
    of = np.asarray(clique_of, np.int32)
    part = partition_from_of(of.shape[0], of)
    E = np.array(E, np.float64)
    anchor = np.array(anchor, np.int32)
    if E.shape != (part.k, m) or anchor.shape != (part.k,):
        raise ValueError(
            f"E {E.shape} / anchor {anchor.shape} do not fit {part.k} "
            f"cliques on {m} servers")
    return CacheState(partition=part, E=E, anchor=anchor, m=int(m))


def window_crm_from_arrays(hot_items, raw, norm, binary) -> WindowCRM:
    """The AKPC policy's previous-window CRM from its compact arrays."""
    return WindowCRM(
        hot_items=np.asarray(hot_items, np.int32),
        raw=np.asarray(raw, np.int64),
        norm=np.asarray(norm, np.float32),
        binary=np.asarray(binary, bool),
    )


def resume_policy(policy, *, clique_of=None, prev_crm: WindowCRM | None = None,
                  keep=None) -> None:
    """Carry a policy's window state into a bound port policy: the current
    partition (``clique_of``, (n,)) and previous-window CRM of an AKPC
    policy whose clique generation runs on the host, or the (n,)
    keep-or-not mask of a TTL policy.  The policy must be bound to the
    catalog first."""
    if clique_of is not None:
        of = np.asarray(clique_of, np.int32)
        policy._partition = partition_from_of(of.shape[0], of)
    if prev_crm is not None:
        policy._prev_crm = prev_crm
    if keep is not None:
        keep = np.array(keep, dtype=bool)
        if keep.shape != (policy.n,):
            raise ValueError(f"keep mask shape {keep.shape} != ({policy.n},)")
        policy._keep = keep
