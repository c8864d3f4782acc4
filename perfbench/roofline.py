"""Peaks of the card and the bytes and operations a kernel's inputs need.

Frozen from ``src/repro_torch/bench/common.py`` (the peaks, ``bound``)
and ``src/repro_torch/bench/kernel_bench.py`` (``scan_bound`` and the
``crm_update`` byte count) at commit 63887c5.  Each input byte is read
once and each output byte written once, whatever a kernel reads again.
"""
from __future__ import annotations

import re

#: NVIDIA H100 SXM data sheet, dense rates, at a 700 W power limit: fp64
#: outside the tensor cores (the scans' float64 adds and compares) and
#: HBM3 bandwidth
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12

#: the device kernels each program wrapper launches, by symbol name
DEVICE_NAMES = {
    "crm_update": ("crm_narrow_kernel", "crm_mid_kernel", "crm_wide_kernel"),
    "seg_scan_step": ("seg_scan_step_kernel",),
}


def bound_s(ops: float, peak_ops: float, nbytes: float) -> float:
    """Least seconds for ``ops`` at ``peak_ops`` and ``nbytes`` at HBM."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


def crm_update_bound(H_shape: tuple) -> float:
    """``crm_update`` on H (rows, h) or laned (S, rows, h): H read once,
    the (S, h, h) float32 counts written once; its few integer adds a
    row bound nothing."""
    S, rows, h = (1, *H_shape) if len(H_shape) == 2 else H_shape
    return bound_s(0.0, PEAK_FP64, 4.0 * (S * rows * h + S * h * h))


def seg_scan_step_bound(S: int, L: int, m: int, G: int = 1) -> float:
    """``seg_scan_step`` over S lanes of L events: its G rows of event
    inputs (shared when G is 1), the lane map, dt (S, m), three outputs;
    its adds and compares at the fp64 peak."""
    return bound_s(4.0 * S * L, PEAK_FP64,
                   2.0 * G * L * (8 + 8 + 1) + 8.0 * S * m + 24.0 * S * L
                   + (8.0 * S if G > 1 else 0.0))


def launch_bound(kernel: str, args: tuple) -> float:
    """The bound of one launch from the wrapper's arguments."""
    if kernel == "crm_update":
        return crm_update_bound(tuple(args[0].shape))
    if kernel == "seg_scan_step":
        t_s, dt = args[0], args[6]
        rows = args[7] if len(args) > 7 else None
        S, m = int(dt.shape[0]), int(dt.shape[1])
        L = int(t_s.shape[-1])
        G = int(t_s.shape[0]) if rows is not None and t_s.dim() == 2 else 1
        return seg_scan_step_bound(S, L, m, G)
    raise KeyError(kernel)


def is_symbol(name: str, symbol: str) -> bool:
    """Whether a device kernel's name (with return type, namespace,
    template arguments and parameters, as the profiler gives it) is the
    kernel ``symbol``."""
    return re.search(r"(^|[^\w])" + re.escape(symbol) + r"\s*[(<]",
                     name) is not None
