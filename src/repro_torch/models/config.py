"""Model configuration covering all 10 assigned architecture families.

A copy of ``repro.models.config`` (pure Python dataclasses), kept in the
port so that it imports nothing of the JAX package.

One dataclass parameterises: dense GQA transformers (w/ optional QKV bias,
sliding-window attention, tied embeddings), MLA (DeepSeek-V2), MoE (routed +
shared experts), Mamba2 hybrids (Zamba2), xLSTM, encoder-decoder (Whisper)
and VLM backbones (Phi-3-vision).  The per-arch files in ``repro_torch/configs``
instantiate it with the exact assigned hyper-parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
BlockKind = Literal["attn", "mamba2", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0               # shared (always-on) experts
    first_k_dense: int = 0          # leading dense layers (DeepSeek-V2: 1)
    d_ff_dense: int = 0             # ffn width of those dense layers
    router_noise: float = 0.0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001

    @property
    def n_experts_padded(self) -> int:
        """Expert count padded to a multiple of 16 so the expert dim shards
        evenly over any model-axis size we deploy (16-way TP per pod).
        Padded experts have zero weights and the router never emits them."""
        return -(-self.n_experts // 16) * 16


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64               # per-head SSD state size
    d_conv: int = 4                 # depthwise conv width
    expand: int = 2                 # inner dim = expand * d_model
    head_dim: int = 64
    chunk: int = 256                # chunked-scan block length
    # hybrid (Zamba2): one SHARED attention block applied every k SSM layers
    shared_attn_every: int = 0


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    mlstm_per_group: int = 3        # block pattern: N mLSTM then 1 sLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 4
    n_decoder_layers: int = 4
    # the conv/mel frontend is a STUB: input_specs() provides precomputed
    # frame embeddings (assignment: backbone only)
    max_source_len: int = 1500


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    # CLIP-style patch frontend is a STUB: input_specs() provides precomputed
    # patch embeddings which are prepended to the token embeddings
    n_patches: int = 576
    d_patch: int = 1024             # frontend embedding dim (projected to d)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                          # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["silu", "gelu"] = "silu"
    rope_theta: float = 10000.0
    swa_window: int = 0                      # 0 = full attention
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # "int8" halves KV-cache HBM (fixed-scale symmetric quantisation; a
    # production deployment calibrates per-head scales) — used by the
    # big-MHA decode cells where 32k x batch-128 caches run HBM out
    kv_cache_dtype: str = "bfloat16"
    # attention implementation: "dense" materialises (S, S) scores; "chunked"
    # scans KV blocks with an online softmax (required for 32k+ prefill)
    attn_impl: Literal["dense", "chunked"] = "dense"
    attn_chunk: int = 1024
    # sub-quadratic? (drives long_500k applicability)
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.swa_window > 0 or (
            self.xlstm is not None
        )

    @property
    def has_decoder(self) -> bool:
        return True                          # all assigned archs can decode

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.mla
        if self.family == "moe":
            assert self.moe is not None
        if self.family in ("ssm", "hybrid"):
            assert self.ssm is not None or self.xlstm is not None
        if self.family == "encdec":
            assert self.encdec is not None
        if self.family == "vlm":
            assert self.vlm is not None

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts routed experts
        only at top_k/n_experts utilisation (MoE roofline convention)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d                                  # embedding
        if not self.tie_embeddings:
            n += self.vocab * d                             # lm head
        if self.xlstm is not None:
            pf_m, pf_s = self.xlstm.proj_factor_mlstm, self.xlstm.proj_factor_slstm
            di_m = int(d * pf_m)                 # mLSTM: up/down + q,k,v,gates
            per_m = 2 * d * di_m + 4 * di_m * di_m
            di_s = int(d * pf_s)                 # sLSTM: 4 gates + ffn
            per_s = 4 * d * d + 2 * d * di_s
            g = self.xlstm.mlstm_per_group
            n_s = L // (g + 1)
            n_m = L - n_s
            return n + n_m * per_m + n_s * per_s
        if self.ssm is not None:
            di = self.ssm.expand * d
            per_ssm = d * (2 * di + 2 * self.n_heads * self.ssm.d_state) + di * d
            n_attn_shared = 0
            if self.ssm.shared_attn_every > 0:
                n_attn_shared = (
                    4 * d * d + 3 * d * self.d_ff
                )                                            # one shared block
            return n + L * per_ssm + n_attn_shared
        # attention params
        hd = self.head_dim
        if self.mla is not None:
            m = self.mla
            per_attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                + d * (m.kv_lora_rank + m.rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            per_attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        # mlp params
        act_fac = 3 if self.activation == "silu" else 2     # swiglu vs gelu
        if self.moe is not None:
            mo = self.moe
            dense_layers = mo.first_k_dense
            moe_layers = L - dense_layers
            per_dense = act_fac * d * (mo.d_ff_dense or self.d_ff)
            n_routed = mo.n_experts if not active_only else mo.top_k
            per_moe = (
                act_fac * d * mo.d_ff_expert * (n_routed + mo.n_shared)
                + d * mo.n_experts                           # router
            )
            mlp = dense_layers * per_dense + moe_layers * per_moe
        else:
            mlp = L * act_fac * d * self.d_ff
        total = n + L * per_attn + mlp
        if self.encdec is not None:
            # decoder cross-attention adds one more attention block per layer
            total += self.encdec.n_decoder_layers * (
                4 * d * self.n_heads * hd
            )
        return int(total)

    def flops_per_token(self, seq_len: int, decode: bool = False) -> float:
        """MODEL_FLOPS/token: 6*N_active (+ attention window term)."""
        n_active = self.param_count(active_only=True) - (
            0 if self.tie_embeddings else self.vocab * self.d_model
        )
        f = 6.0 * n_active
        if self.family not in ("ssm",) and self.xlstm is None:
            win = seq_len if not self.swa_window else min(seq_len, self.swa_window)
            kv_len = win if not decode else win
            f += 12.0 * self.n_layers * self.head_dim * self.n_heads * (
                kv_len if not decode else kv_len
            ) * (0.5 if not decode else 1.0)
        return f


def scaled_init(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))
