"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

A wrapper launches its kernel for CUDA tensors (and counts the launch in
``<wrapper>.launches``) and runs the plain version for CPU tensors; there
is no fallback from one to the other.  The sources are built at first use
(:mod:`repro_torch.kernels._build`).
"""
from .clique_density import clique_pair_edges, clique_pair_edges_plain
from .crm_update import crm_update, crm_update_plain
from .merge_step import merge_density, merge_density_plain
from .packed_lookup import (
    packed_lookup,
    packed_lookup_plain,
    unpacked_lookup,
    unpacked_lookup_plain,
)
from .segment_reduce import (
    seg_running_argmax,
    seg_running_argmax_plain,
    seg_running_max,
    seg_running_max_plain,
    seg_scan_step,
    seg_scan_step_plain,
)

#: every kernel wrapper of the port, by name (``seg_scan_step`` runs the
#: device code of both scans in one launch a replay step)
KERNELS = {
    "crm_update": crm_update,
    "clique_pair_edges": clique_pair_edges,
    "merge_density": merge_density,
    "seg_running_argmax": seg_running_argmax,
    "seg_running_max": seg_running_max,
    "seg_scan_step": seg_scan_step,
    "packed_lookup": packed_lookup,
    "unpacked_lookup": unpacked_lookup,
}

__all__ = [
    "KERNELS",
    "clique_pair_edges",
    "clique_pair_edges_plain",
    "crm_update",
    "crm_update_plain",
    "merge_density",
    "merge_density_plain",
    "packed_lookup",
    "packed_lookup_plain",
    "seg_running_argmax",
    "seg_running_argmax_plain",
    "seg_running_max",
    "seg_running_max_plain",
    "seg_scan_step",
    "seg_scan_step_plain",
    "unpacked_lookup",
    "unpacked_lookup_plain",
]
