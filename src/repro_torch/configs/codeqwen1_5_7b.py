"""codeqwen1.5-7b [dense]: 32L d=4096 32H (kv=32 -> MHA) d_ff=13440
vocab=92416  [hf:Qwen/CodeQwen1.5-7B]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    attn_impl="chunked",
    kv_cache_dtype="int8",
)

SMOKE = ModelConfig(
    name="codeqwen-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
)
