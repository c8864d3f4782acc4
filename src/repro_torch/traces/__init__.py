"""Request traces: the container and the seeded synthetic generators."""
from .loader import Trace
from .synthetic import SynthConfig, paper_trace, synth_trace

__all__ = ["Trace", "SynthConfig", "paper_trace", "synth_trace"]
