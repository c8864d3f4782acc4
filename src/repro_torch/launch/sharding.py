"""Sharding rules (port of ``repro.launch.sharding``): parameters (FSDP x
TP), optimizer state, KV / SSM caches, batches.

Scheme:
* TP ("model" axis): attention head / ffn / expert / vocab dims;
* FSDP ("data" axis): the d_model-ish contraction dim of every large
  matrix (params are 2-D sharded); gradients reduce-scatter, params
  all-gather at use;
* the "pod" axis extends data parallelism only (params replicated across
  pods, the optimizer moments additionally sharded over it);
* decode caches shard the SEQUENCE dim over "model", batch over DP when
  divisible.

Every rule falls back to replication when a dim is not divisible by the
axis size, so any (arch x mesh) combination has a spec.  A spec is a
statement about placement: :class:`NamedSharding` gives a leaf's shard
shape and bytes a device, which the dry run
(:mod:`repro_torch.launch.cost_analysis`) sums; nothing here moves data.
The rule tables are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.shard_ctx import PartitionSpec
from .mesh import dp_axes

P = PartitionSpec

# params whose TP dim is the LAST axis (column-parallel): y = x @ W
_COL = {"wq", "wk", "wv", "wi", "wg", "up", "wx", "wr", "in_proj", "wq_b",
        "wkv_b", "ffn_wi", "w_if", "bq", "bk", "bv"}
# params whose TP dim is the SECOND-TO-LAST axis (row-parallel): y = x @ W
_ROW = {"wo", "down", "out_proj", "ffn_wo"}
# small projections: FSDP only
_FSDP_ONLY = {"wq_a", "wkv_a", "router", "patch_proj", "conv_w"}
_REPL = {"norm", "norm1", "norm2", "norm3", "q_norm", "kv_norm", "gate_norm",
         "out_norm", "final_norm", "enc_final", "dec_final", "A_log",
         "dt_bias", "D", "scale", "bias", "shared_norm1", "shared_norm2",
         "ffn_norm", "step"}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple:
        """The shape one device holds of a ``shape`` leaf."""
        out = list(shape)
        for i, entry in enumerate(self.spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            for name in names:
                if name is not None:
                    out[i] //= self.mesh.shape[name]
        return tuple(out)

    def shard_bytes(self, shape, dtype) -> int:
        """The bytes one device holds of a ``shape`` leaf of ``dtype``."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        return math.prod(self.shard_shape(shape)) * itemsize


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _axis(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 0


def _key(entry) -> str:
    """A path entry's name: a dict key, or an object with ``.key`` /
    ``.name`` (JAX's key-path entries)."""
    return str(getattr(entry, "key", getattr(entry, "name", entry)))


def _leaf_name(path) -> str:
    return _key(path[-1]) if path else ""


def _path_has(path, *names) -> bool:
    keys = {_key(e) for e in path}
    return any(n in keys for n in names)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict, ``path`` the tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_spec(path, leaf, mesh, serving: bool = False) -> P:
    """PartitionSpec for one parameter.

    ``serving=True`` (decode cells): expert weights switch to the
    WEIGHT-STATIONARY layout (ff over `data` instead of d) so tiny decode
    batches never all-gather expert weights."""
    name = _leaf_name(path)
    shape = leaf.shape
    nd = len(shape)
    dsz, msz = _axis(mesh, "data"), _axis(mesh, "model")
    if name in _REPL or nd <= 1:
        return P()
    spec: list[Any] = [None] * nd
    is_expert = _path_has(path, "mlp") and nd == 4          # (L, E, d, ff)

    if serving and is_expert and name in ("wi", "wg"):       # (L, E, d, ff)
        if _div(shape[1], msz):
            spec[1] = "model"
        if _div(shape[3], dsz):
            spec[3] = "data"
        return P(*spec)
    if serving and is_expert and name == "wo":               # (L, E, ff, d)
        if _div(shape[1], msz):
            spec[1] = "model"
        if _div(shape[2], dsz):
            spec[2] = "data"
        return P(*spec)

    if name == "embed":                                      # (V, d)
        if _div(shape[0], msz):
            spec[0] = "model"
        if _div(shape[1], dsz):
            spec[1] = "data"
    elif name == "lm_head":                                  # (d, V)
        if _div(shape[0], dsz):
            spec[0] = "data"
        if _div(shape[1], msz):
            spec[1] = "model"
    elif is_expert and name in ("wi", "wg"):                 # (L, E, d, ff)
        if _div(shape[1], msz):
            spec[1] = "model"
        if _div(shape[2], dsz):
            spec[2] = "data"
    elif is_expert and name == "wo":                         # (L, E, ff, d)
        if _div(shape[1], msz):
            spec[1] = "model"
        if _div(shape[3], dsz):
            spec[3] = "data"
    elif name in _COL:
        if _div(shape[-1], msz):
            spec[-1] = "model"
        if nd >= 2 and _div(shape[-2], dsz):
            spec[-2] = "data"
    elif name in _ROW:
        if _div(shape[-2], msz):
            spec[-2] = "model"
        if _div(shape[-1], dsz):
            spec[-1] = "data"
    elif name in _FSDP_ONLY:
        if nd >= 2 and _div(shape[-2], dsz):
            spec[-2] = "data"
    else:                                                    # generic fallback
        if _div(shape[-1], msz):
            spec[-1] = "model"
        if nd >= 2 and _div(shape[-2], dsz):
            spec[-2] = "data"
    return P(*spec)


def param_shardings(params_shape, mesh, serving: bool = False):
    """Tree of :class:`NamedSharding` s matching a params (shape) tree."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_spec(path, leaf, mesh, serving=serving)),
        params_shape)


def opt8_state_shardings(params_shape, mesh):
    """Shardings for the 8-bit optimizer tree: the int8 moments mirror the
    params; the blockwise scales mirror too, except that the (blocked)
    last dim falls back to replication when indivisible."""
    def per_param(path, leaf):
        base = param_spec(path, leaf, mesh)
        spec = list(base) + [None] * (len(leaf.shape) - len(base))
        nb = -(-leaf.shape[-1] // 128) if len(leaf.shape) else 1
        s_spec = list(spec)
        ax = _axis(mesh, "model") if spec and spec[-1] == "model" else (
            _axis(mesh, "data") if spec and spec[-1] == "data" else 0)
        if not (ax and nb % ax == 0):
            s_spec[-1] = None
        return {
            "m_q": NamedSharding(mesh, P(*spec)),
            "m_s": NamedSharding(mesh, P(*s_spec)),
            "v_q": NamedSharding(mesh, P(*spec)),
            "v_s": NamedSharding(mesh, P(*s_spec)),
        }

    return {"mv": tree_map_with_path(per_param, params_shape),
            "step": NamedSharding(mesh, P())}


def opt_state_shardings(params_shape, mesh):
    """m / v mirror the params, additionally sharded over the pod axis
    wherever a dim is over "data" (the moments are touched once a step);
    step is replicated."""
    pshard = param_shardings(params_shape, mesh)
    if "pod" in mesh.axis_names:
        def extend(path, ns):
            return NamedSharding(mesh, P(*(
                ("pod", "data") if entry == "data" else entry
                for entry in ns.spec)))

        mshard = tree_map_with_path(extend, pshard)
    else:
        mshard = pshard
    return {"m": mshard, "v": mshard, "step": NamedSharding(mesh, P())}


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------
def batch_spec(shape, mesh, *, leading_accum: bool = False) -> P:
    """Shard the batch dim over DP axes (axis 0, or 1 under grad-accum)."""
    dp = dp_axes(mesh)
    dp_n = math.prod(mesh.shape[a] for a in dp)
    bdim = 1 if leading_accum else 0
    spec: list[Any] = [None] * len(shape)
    if len(shape) > bdim and _div(shape[bdim], dp_n):
        spec[bdim] = dp
    return P(*spec)


def batch_shardings(batch_shape, mesh, *, leading_accum: bool = False):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, batch_spec(leaf.shape, mesh, leading_accum=leading_accum)),
        batch_shape)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------
_SEQ_AXIS = {"k": 2, "v": 2, "c": 2, "r": 2}     # (L, B, S, ...)


def cache_spec(path, leaf, mesh) -> P:
    name = _leaf_name(path)
    shape = leaf.shape
    nd = len(shape)
    msz = _axis(mesh, "model")
    dp = dp_axes(mesh)
    dp_n = math.prod(mesh.shape[a] for a in dp)
    spec: list[Any] = [None] * nd

    if name in _SEQ_AXIS and nd >= 4:
        b_ax, s_ax = 1, 2
        if _div(shape[b_ax], dp_n):
            spec[b_ax] = dp
            if _div(shape[s_ax], msz):
                spec[s_ax] = "model"
        elif _div(shape[s_ax], msz * dp_n):
            # tiny batch (long_500k): context-parallel over ALL axes
            spec[s_ax] = dp + ("model",)
        elif _div(shape[s_ax], msz):
            spec[s_ax] = "model"
        return P(*spec)

    # recurrent states (ssm/mlstm/slstm/conv): batch over DP, widest inner
    # dim over model
    if nd >= 2 and _div(shape[1], dp_n):
        spec[1] = "data" if dp == ("data",) else dp
    inner = list(range(2, nd))
    inner.sort(key=lambda i: -shape[i])
    for i in inner:
        if _div(shape[i], msz):
            spec[i] = "model"
            break
    return P(*spec)


def cache_shardings(cache_shape, mesh):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, cache_spec(path, leaf, mesh)),
        cache_shape)


def shard_bytes(tree, shardings) -> int:
    """The bytes a device holds of a tensor tree under ``shardings``."""
    if isinstance(tree, dict):
        return sum(shard_bytes(v, shardings[k]) for k, v in tree.items())
    return shardings.shard_bytes(tree.shape, tree.dtype)
