"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304, sLSTM + mLSTM blocks
(3 mLSTM : 1 sLSTM)  [arXiv:2405.04517]."""
from ..models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    tie_embeddings=True,
    xlstm=XLSTMConfig(mlstm_per_group=3),
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    tie_embeddings=True,
    xlstm=XLSTMConfig(mlstm_per_group=3, chunk=16),
)
