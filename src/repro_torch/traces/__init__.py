"""Request traces: the container, its batch and window helpers, and the
seeded synthetic generators."""
from .loader import (
    Trace,
    TraceBatches,
    batch_tensors,
    iter_batch_tensors,
    iter_batches,
    iter_windows,
)
from .synthetic import (
    SynthConfig,
    paper_trace,
    paper_trace_batches,
    synth_trace,
    synth_trace_batches,
)

__all__ = [
    "Trace",
    "TraceBatches",
    "batch_tensors",
    "iter_batch_tensors",
    "iter_batches",
    "iter_windows",
    "synth_trace",
    "synth_trace_batches",
    "paper_trace",
    "paper_trace_batches",
    "SynthConfig",
]
