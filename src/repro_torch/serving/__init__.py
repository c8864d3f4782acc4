"""Serving on the card: the persistent live engine (port of ``repro.serving``)."""
from .live import LiveServingEngine, ServeFuture

__all__ = ["LiveServingEngine", "ServeFuture"]
