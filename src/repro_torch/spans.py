"""Named host spans for ``torch.profiler`` traces: the port's one span
mechanism.

:func:`span` is ``torch.profiler.record_function(name)`` while a profiler
runs in this process and one shared do-nothing context otherwise, so an
untraced call pays a flag check, not a ``record_function``.  The ranges
lie on the profiler's own clock, the one its device events use, so a
trace can name each device gap by the span open where it starts.
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager that marks ``name`` in a running profiler's trace
    (and does nothing when none runs)."""
    return torch.profiler.record_function(name) if _profiling() else _NULL
