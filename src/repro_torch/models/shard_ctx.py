"""Ambient sharding hints for model internals (port of ``repro.models.shard_ctx``).

The step entry points install a mesh here and layers call
``constrain(x, dims)`` / ``constrain_cache(x, b_axis, s_axis)`` where the
reference pins activation shardings.  Without a mesh both are the
identity, as in the reference's ``mesh is None`` branch.  The port has no
production mesh yet (ROADMAP, queue 1, item 6: the production mesh), so a
hint under an installed mesh raises instead of silently ignoring it.
"""
from __future__ import annotations

import contextlib
import threading

_TLS = threading.local()


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


def _no_mesh(what: str):
    raise NotImplementedError(
        f"{what} under a mesh needs the production mesh (make_production_mesh, "
        "launch/sharding.py), which the port does not have yet (ROADMAP, "
        "queue 1, item 6: the production mesh)")


def constrain(x, dims):
    """dims: tuple like ("dp", None, "model", None) matching x.ndim."""
    if current_mesh() is None:
        return x
    _no_mesh("constrain")


def constrain_cache(x, b_axis: int, s_axis: int):
    """KV-cache sharding hint: the identity without a mesh."""
    if current_mesh() is None:
        return x
    _no_mesh("constrain_cache")
