"""zamba2-1.2b [hybrid]: 38L d=2048 32H d_ff=8192 vocab=32000 ssm_state=64,
Mamba2 stack + ONE weight-shared attention block applied every 6 layers
[arXiv:2411.15242]."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  shared_attn_every=6),
    attn_impl="chunked",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                  shared_attn_every=2, chunk=16),
)
