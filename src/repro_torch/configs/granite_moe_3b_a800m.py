"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (kv=8) d_ff(expert)=512
vocab=49155, 40 experts top-8  [hf:ibm-granite]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, n_shared=0),
    tie_embeddings=True,
    attn_impl="chunked",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=0),
    tie_embeddings=True,
)
