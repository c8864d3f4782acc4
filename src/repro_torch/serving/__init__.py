"""Serving on the card: the persistent live engine and the MoE expert cache (port of ``repro.serving``)."""
from .expert_cache import ExpertCacheManager, ExpertCacheStats
from .live import LiveServingEngine, ServeFuture

__all__ = ["ExpertCacheManager", "ExpertCacheStats", "LiveServingEngine",
           "ServeFuture"]
