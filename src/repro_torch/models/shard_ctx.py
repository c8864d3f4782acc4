"""Ambient sharding hints for model internals (port of ``repro.models.shard_ctx``).

The step entry points install a mesh here and layers call
``constrain(x, dims)`` / ``constrain_cache(x, b_axis, s_axis)`` where the
reference pins activation shardings.  Every hint is divisibility-guarded:
a dim that does not divide by its axis size falls back to replication.

A hint is a statement about placement: on the port's single-process mesh
(:class:`~repro_torch.launch.mesh.SweepMesh`) both return ``x`` unchanged,
as a sharding constraint leaves values unchanged.  The spec each one
computes is the reference's, and :func:`constrain_spec` /
:func:`cache_constrain_spec` return it.

Where the reference issues a collective by hand (the MoE layer's
``psum`` in ``shard_map``), the port's layer notes it with
:func:`record_collective`; the dry run's cost model
(:mod:`repro_torch.launch.cost_analysis`) reads the notes under
:func:`recording_collectives`.

dims vocabulary:  "dp" (batch over pod+data), "model", None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

_TLS = threading.local()


class PartitionSpec(tuple):
    """A tuple of per-dimension mesh axes (``None``, an axis name or a
    tuple of names), as ``jax.sharding.PartitionSpec``: a one-name tuple
    is stored as the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def current_mesh():
    return getattr(_TLS, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield
    finally:
        _TLS.mesh = prev


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a layer issues: ``kind`` ("all-reduce", ...), the
    per-device output bytes, the group size, who issued it and whether a
    backward follows (remat's recompute and the transposed collective then
    run there too)."""

    kind: str
    out_bytes: int
    group: int
    what: str
    backward_follows: bool


def record_collective(kind: str, out_bytes: int, group: int, what: str
                      ) -> None:
    """Note a collective under :func:`recording_collectives`; else no-op.
    Remat's recompute inside a backward notes nothing (it runs on the
    autograd engine's thread on CUDA, on the caller's on the CPU): its
    forward's note stands for it."""
    log = getattr(_TLS, "collectives", None)
    if log is None or torch._C._current_graph_task_id() != -1:
        return
    log.append(Collective(kind, int(out_bytes), int(group), what,
                          torch.is_grad_enabled()))


@contextlib.contextmanager
def recording_collectives():
    """Collect the :class:`Collective` s the layers note (a list)."""
    prev = getattr(_TLS, "collectives", None)
    _TLS.collectives = log = []
    try:
        yield log
    finally:
        _TLS.collectives = prev


def _dp(mesh) -> tuple[tuple, int, int]:
    """(dp axes, their product, the model axis size or 0)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp_n = 1
    for a in dp:
        dp_n *= mesh.shape[a]
    msz = mesh.shape["model"] if "model" in mesh.axis_names else 0
    return dp, dp_n, msz


def constrain_spec(shape, dims, mesh) -> PartitionSpec:
    """The spec ``constrain`` pins for a tensor of ``shape`` on ``mesh``."""
    dp, dp_n, msz = _dp(mesh)
    spec = []
    for d, size in zip(dims, shape):
        if d == "dp" and dp_n > 1 and size % dp_n == 0:
            spec.append(dp)
        elif d == "model" and msz > 1 and size % msz == 0:
            spec.append("model")
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def cache_constrain_spec(shape, b_axis: int, s_axis: int, mesh
                         ) -> PartitionSpec:
    """The spec ``constrain_cache`` pins: batch over DP and seq over model
    when divisible; a tiny-batch (long-context) cache puts the seq dim
    over ALL axes instead.  Mirrors ``launch.sharding.cache_spec``."""
    dp, dp_n, msz = _dp(mesh)
    spec: list = [None] * len(shape)
    B, S = shape[b_axis], shape[s_axis]
    if dp_n > 1 and B % dp_n == 0:
        spec[b_axis] = dp
        if msz > 1 and S % msz == 0:
            spec[s_axis] = "model"
    elif msz > 1 and dp_n >= 1 and S % (dp_n * msz) == 0:
        spec[s_axis] = dp + ("model",)
    elif msz > 1 and S % msz == 0:
        spec[s_axis] = "model"
    return PartitionSpec(*spec)


def constrain(x, dims):
    """dims: tuple like ("dp", None, "model", None) matching x.ndim;
    returns ``x`` (see the module docstring)."""
    mesh = current_mesh()
    if mesh is not None:
        constrain_spec(x.shape, dims, mesh)
    return x


def constrain_cache(x, b_axis: int, s_axis: int):
    """KV-cache sharding hint; returns ``x`` (see the module docstring)."""
    mesh = current_mesh()
    if mesh is not None:
        cache_constrain_spec(x.shape, b_axis, s_axis, mesh)
    return x
