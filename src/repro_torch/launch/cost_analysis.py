"""The dry run's cost model: FLOPs, HBM bytes, collective wire bytes,
memory and the roofline of one cell (the counterpart of the reference's
``launch/hlo_analysis.py`` walk over partitioned HLO).

PyTorch has no partitioned program to walk, so the cell's step runs once
on meta tensors (shapes and dtypes, no device memory) under PyTorch's own
counters:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (2 * M * N * K a
  product, forward and backward).  The step's eager loops run every layer
  and every shard, so no trip-count multiplier is needed;
* HBM bytes: :class:`TraceCounter`, a ``TorchDispatchMode``, adds the
  operand and result bytes of the MATERIALISING aten ops in
  :data:`MATERIALIZING` only; elementwise ops, views and dtype casts count
  as fused into their producer or consumer (the reference's rule);
* memory: the same mode keeps the bytes of every storage the trace
  creates that is still alive; the largest total is the temporary peak.
  Argument bytes are exact: each leaf's shard shape under its spec
  (:mod:`repro_torch.launch.sharding`);
* collective wire bytes: a MODEL derived from the sharding specs, not a
  measurement of a partitioner.  Under the reference's ring formulas
  (``all-gather`` out/g * (g-1), ``reduce-scatter`` out * (g-1) with out
  the shard, ``all-reduce`` 2 * out/g * (g-1)) it counts: an FSDP
  all-gather of every data-sharded parameter at each use (once a
  forward, once more in a train step's backward, where remat's recompute
  and the gradient share it; expert weights that the weight-stationary
  MoE branch uses in place are never gathered), each microbatch's
  gradient reduce-scatter over "data" (an all-reduce over the DP axes for
  a leaf not sharded over "data", and over "pod" after the scatter), and
  the all-reduce of the (T, d) f32 partials each time an MoE branch runs
  (``shard_ctx.record_collective``; in a train step also remat's recompute
  and the backward's transposed all-reduce);
* per device: FLOPs and HBM bytes are the totals divided by the device
  count, the ideal SPMD split.

Hardware: one H100 SXM (NVIDIA data sheet, dense, 700 W): 989 TFLOP/s
bf16, 3.35 TB/s HBM3, 80 GB, and 450 GB/s a direction of NVLink 4 for the
link term.  A 256-card mesh also crosses InfiniBand between its nodes,
which this term does not model.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..bench.common import PEAK_BF16, PEAK_BYTES
from ..models.shard_ctx import recording_collectives
from .mesh import dp_axes

PEAK_FLOPS = PEAK_BF16
HBM_BW = PEAK_BYTES
#: NVLink 4, one direction (18 links of 25 GB/s)
LINK_BW = 450e9
HBM_PER_DEVICE = 80e9

#: aten ops whose operands and results cross HBM (products, gathers and
#: scatters, reductions, sorts, concatenations, copies); every other op is
#: taken as fused
MATERIALIZING = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "convolution", "convolution_backward",
    "embedding", "embedding_dense_backward", "index", "index_select",
    "gather", "scatter", "scatter_add", "scatter_reduce", "index_put",
    "index_put_", "index_add", "slice_scatter", "select_scatter",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
    "linalg_vector_norm", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "cat", "stack", "sort", "topk", "clone", "copy_",
})


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """HBM bytes of the materialising ops, and the live bytes of the
    storages the trace creates (their peak).  The storages of ``keep``
    (the step's arguments) are not the trace's."""

    def __init__(self, keep=()):
        super().__init__()
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = {t.untyped_storage()._cdata for t in tree_leaves(keep)
                      if isinstance(t, torch.Tensor)}

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.overloadpacket.__name__ in MATERIALIZING:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.hbm_bytes += sum(map(_tensor_bytes, ins + outs))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._seen:
                self._seen.add(key)
                self.live += st.nbytes()
                weakref.finalize(st, self._free, key, st.nbytes())
        self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class TraceCost:
    """What one traced call did: FLOPs, HBM bytes, the temporary peak (all
    totals over the mesh) and the collectives the layers noted."""

    flops: float
    hbm_bytes: float
    peak_bytes: int
    collectives: list


def trace(fn, *args, keep=()):
    """``(fn(*args), TraceCost)`` of one call under the counters."""
    with recording_collectives() as log, \
            FlopCounterMode(display=False) as fc, \
            TraceCounter(keep=(args, keep)) as tc:
        out = fn(*args)
    return out, TraceCost(float(fc.get_total_flops()), float(tc.hbm_bytes),
                          tc.peak, log)


# ---------------------------------------------------------------------------
# collectives (a model from the specs)
# ---------------------------------------------------------------------------
def ring_wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Wire bytes a device sends for one collective under a ring."""
    g = group
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes / g * (g - 1)
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * out_bytes / g * (g - 1)
    raise ValueError(f"no ring formula for {kind!r}")


def _axes_in(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _groups(sharding) -> tuple[int, int]:
    """(the product of the DP axes a spec shards over, of the others)."""
    dp, other = 1, 1
    for entry in sharding.spec:
        for a in _axes_in(entry):
            if a in ("pod", "data"):
                dp *= sharding.mesh.shape[a]
            else:
                other *= sharding.mesh.shape[a]
    return dp, other


def _is_expert(path, leaf) -> bool:
    return "mlp" in path and leaf.dim() == 4 and path[-1] in ("wi", "wg", "wo")


def _leaves_with_path(tree, shardings, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, shardings[k], path + (k,))
    else:
        yield path, tree, shardings


class CollectiveTally:
    """Wire bytes a device sends and collective counts, by kind."""

    def __init__(self):
        self.bytes: dict = {}
        self.counts: dict = {}

    def add(self, kind: str, out_bytes: float, group: int,
            times: float = 1.0) -> None:
        wire = ring_wire_bytes(kind, out_bytes, group)
        if wire:
            self.bytes[kind] = self.bytes.get(kind, 0.0) + wire * times
            self.counts[kind] = self.counts.get(kind, 0) + times


def param_collectives(tally: CollectiveTally, params, pshard, mesh, *,
                      uses: int, grad_reductions: int,
                      stationary_experts: bool) -> None:
    """FSDP all-gathers (``uses`` a step) and gradient reductions
    (``grad_reductions`` a step) of every parameter leaf."""
    dp_n = 1
    for a in dp_axes(mesh):
        dp_n *= mesh.shape[a]
    pods = mesh.shape.get("pod", 1)
    for path, leaf, ns in _leaves_with_path(params, pshard):
        full = _tensor_bytes(leaf)
        shard = ns.shard_bytes(leaf.shape, leaf.dtype)
        g_dp, g_other = _groups(ns)
        if uses and g_dp > 1 and not (stationary_experts
                                      and _is_expert(path, leaf)):
            tally.add("all-gather", full / g_other, g_dp, uses)
        if not grad_reductions:
            continue
        if g_dp > 1:
            tally.add("reduce-scatter", shard, g_dp, grad_reductions)
            tally.add("all-reduce", shard, pods, grad_reductions)
        else:
            tally.add("all-reduce", shard, dp_n, grad_reductions)


def layer_collectives(tally: CollectiveTally, records: list,
                      times: int = 1) -> None:
    """The collectives the layers noted; where a backward follows, remat's
    recompute and the transposed collective too (three a note)."""
    for r in records:
        tally.add(r.kind, r.out_bytes, r.group,
                  times * (3 if r.backward_follows else 1))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float
    n_devices: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_dev * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """(model FLOPs / devices / peak) / bound: the cell's score."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops / self.n_devices / PEAK_FLOPS / self.bound_s


def make_roofline(flops_per_dev: float, hbm_bytes_per_dev: float,
                  coll_bytes_per_dev: float, n_devices: int,
                  model_flops: float) -> Roofline:
    return Roofline(
        compute_s=flops_per_dev / PEAK_FLOPS,
        memory_s=hbm_bytes_per_dev / HBM_BW,
        collective_s=coll_bytes_per_dev / LINK_BW,
        flops_per_dev=flops_per_dev,
        hbm_bytes_per_dev=hbm_bytes_per_dev,
        coll_bytes_per_dev=coll_bytes_per_dev,
        model_flops=model_flops,
        n_devices=n_devices,
    )
