"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H d_ff=8192 vocab=32064,
phi3-mini backbone + CLIP patch frontend STUB (input_specs provides
precomputed patch embeddings)  [hf:microsoft/Phi-3-vision-128k-instruct]."""
from ..models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    vlm=VLMConfig(n_patches=576, d_patch=1024),
    attn_impl="chunked",
    kv_cache_dtype="int8",
)

SMOKE = ModelConfig(
    name="phi3v-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    vlm=VLMConfig(n_patches=16, d_patch=32),
)
