"""Optimisers of the port (``repro.optim``'s AdamW over dicts of tensors)."""
from .adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    tree_leaves,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "tree_leaves",
]
