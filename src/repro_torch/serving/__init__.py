"""Serving on the card: the persistent live engine, the MoE expert cache and
the continuous-batching model server (port of ``repro.serving``)."""
from .expert_cache import ExpertCacheManager, ExpertCacheStats
from .live import LiveServingEngine, ServeFuture
from .server import BatchedServer, Request

__all__ = ["BatchedServer", "ExpertCacheManager", "ExpertCacheStats",
           "LiveServingEngine", "Request", "ServeFuture"]
