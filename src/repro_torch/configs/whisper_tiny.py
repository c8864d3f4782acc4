"""whisper-tiny [audio]: 4+4L d=384 6H d_ff=1536 vocab=51865, enc-dec;
conv/mel frontend is a STUB (input_specs provides precomputed frame
embeddings)  [arXiv:2212.04356]."""
from ..models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    activation="gelu",
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=4, n_decoder_layers=4),
    attn_impl="chunked",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    norm="layernorm",
    activation="gelu",
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=2, n_decoder_layers=2),
)
