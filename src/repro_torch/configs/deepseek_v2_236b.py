"""deepseek-v2-236b [moe]: 60L d=5120 128H d_ff(expert)=1536 vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed top-6  [arXiv:2405.04434]."""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,            # MLA: latent cache, kv head count unused
    d_ff=12288,                # dense first-layer ffn (HF: intermediate_size)
    vocab=102400,
    d_head=128,
    moe=MoEConfig(
        n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
        first_k_dense=1, d_ff_dense=12288,
    ),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    attn_impl="chunked",
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    d_head=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                  first_k_dense=1, d_ff_dense=128),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                  rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
)
