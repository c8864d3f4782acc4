"""Carry a reference run's data and state into the port, from plain arrays.

Data and state take the place of weights here: a trace, a pricing
scenario's arrays, the cache state of a replay engine, a policy's window
state (the AKPC policy's partition and previous-window CRM, the TTL
policy's keep-or-not mask) and a learned policy's trained scorer; and the
model zoo's parameters, KV caches and optimizer states, so a reference
training run resumes in the port.
Every function takes plain numpy arrays (read off ``repro``'s objects by
the caller), so the port never imports ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.cgm_schedule import partition_from_of
from .core.cost import CacheEnvironment, CostParams
from .core.crm import WindowCRM
from .core.engine import CacheState
from .core.replay import resolve_device
from .models.common import dtype_of
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


def env_from_arrays(n: int, m: int, params: CostParams, lam_j=None,
                    mu_j=None, item_sizes=None) -> CacheEnvironment:
    """A port :class:`CacheEnvironment` from a scenario's per-server prices
    ``lam_j`` / ``mu_j`` (m,) and per-item sizes (n,); None keeps the
    homogeneous default, as in the reference."""
    def arr(a):
        return None if a is None else np.array(a, np.float64)

    return CacheEnvironment(n=int(n), m=int(m), params=params,
                            lam_j=arr(lam_j), mu_j=arr(mu_j),
                            item_sizes=arr(item_sizes))


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


def learned_params_from_tree(tree: dict):
    """A reference ``LearnedParams.tree()`` (its leaves as numpy arrays)
    as the port's :class:`~repro_torch.learned.model.LearnedParams`."""
    from .learned.model import LearnedParams

    return LearnedParams.from_tree(tree)


def _tensor_tree(tree, dtype_for, device, path=()):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, dtype_for, device, path + (k,))
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device=device,
                                                 dtype=dtype_for(path))


#: parameter leaves the reference keeps in f32 whatever ``param_dtype``
#: says: the MoE router and Mamba-2's ``A_log`` / ``dt_bias`` / ``D``
F32_PARAMS = frozenset({"router", "A_log", "dt_bias", "D"})
#: cache leaves the reference keeps in f32 whatever the cache dtype: the
#: SSM state, the mLSTM memory and the sLSTM's ``c`` / ``n``
F32_CACHE = frozenset({"ssm", "mlstm", "slstm_c", "slstm_n"})


def model_params_from_arrays(cfg, tree: dict, device=None) -> dict:
    """The reference's nested parameter dict, its leaves as numpy arrays
    (bf16 leaves upcast to f32 by the caller, which is exact), as the
    port's parameters under the same names: the leaves of
    :data:`F32_PARAMS` in f32, every other leaf in ``cfg.param_dtype``, on
    ``device`` (None: CUDA)."""
    dt = dtype_of(cfg.param_dtype)
    return _tensor_tree(
        tree, lambda path: torch.float32 if path[-1] in F32_PARAMS else dt,
        resolve_device(device))


def cache_from_arrays(tree: dict, dtype, device=None) -> dict:
    """The reference's decode cache or recurrent state (nested dict of
    numpy arrays; bf16 upcast to f32 by the caller) as the port's: the
    leaves of :data:`F32_CACHE` in f32, every other leaf in ``dtype``
    (``torch.bfloat16`` or ``torch.int8``, say), on ``device`` (None:
    CUDA)."""
    return _tensor_tree(
        tree, lambda path: torch.float32 if path[-1] in F32_CACHE else dtype,
        resolve_device(device))


def opt_state_from_arrays(tree: dict, device=None) -> dict:
    """The reference train step's optimizer state (nested dict of numpy
    arrays) as the port's: AdamW's ``{m, v, step}`` or 8-bit AdamW's
    ``{mv: {<param path>: {m_q, m_s, v_q, v_s}}, step}``, with the error
    feedback under ``ef`` where the step compresses.  The codes ``m_q`` /
    ``v_q`` are int8, ``step`` int32, every other leaf (moments, scales,
    residuals) f32; on ``device`` (None: CUDA)."""
    def dtype_for(path):
        if path == ("step",):
            return torch.int32
        if path[0] == "mv" and path[-1] in ("m_q", "v_q"):
            return torch.int8
        return torch.float32

    return _tensor_tree(tree, dtype_for, resolve_device(device))
