"""qwen2.5-3b [dense]: 36L d=2048 16H (kv=2) d_ff=11008 vocab=151936,
GQA with QKV bias  [hf:Qwen/Qwen2.5]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    attn_impl="chunked",
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
)
