"""h2o-danube-1.8b [dense]: 24L d=2560 32H (kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention  [arXiv:2401.16818]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    swa_window=4096,
    attn_impl="chunked",
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    swa_window=32,
)
