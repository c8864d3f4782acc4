"""The training input pipeline with its AKPC shard cache (port of ``repro.data``)."""
from .pipeline import PackedDataPipeline, PipelineTelemetry, ShardStore, TokenBatcher

__all__ = ["PackedDataPipeline", "PipelineTelemetry", "ShardStore", "TokenBatcher"]
