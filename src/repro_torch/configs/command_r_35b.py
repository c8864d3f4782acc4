"""command-r-35b [dense]: 40L d=8192 64H (kv=8) d_ff=22528 vocab=256000,
GQA, no bias  [hf:CohereForAI/c4ai-command-r-v01].
Note: upstream uses parallel attn+FFN blocks and LayerNorm; we keep the
assigned dims with a standard sequential pre-norm block (DESIGN.md §3)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm="layernorm",
    tie_embeddings=True,
    attn_impl="chunked",
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
    norm="layernorm",
    tie_embeddings=True,
)
