"""Optimisers of the port (``repro.optim``): AdamW and 8-bit AdamW over
dicts of tensors, and int8 error-feedback gradient compression."""
from .adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    tree_leaves,
)
from .compress import compress_gradients, decompress_gradients, ef_init

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "compress_gradients",
    "cosine_schedule",
    "decompress_gradients",
    "ef_init",
    "global_norm",
    "tree_leaves",
]
