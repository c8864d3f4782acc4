"""The model zoo on the card (port of ``repro.models``): the decoder family
(dense GQA, MoE, VLM, MLA), the encoder-decoder, the SSM / Zamba2 hybrid
and xLSTM, behind ``build_model``; ``value_and_grad`` for training."""
from .api import Model, build_model, value_and_grad
from .config import (
    EncDecConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    VLMConfig,
    XLSTMConfig,
)
from .linear_attn import chunked_linear_attention, linear_attention_step

__all__ = ["EncDecConfig", "MLAConfig", "Model", "ModelConfig", "MoEConfig",
           "SSMConfig", "VLMConfig", "XLSTMConfig", "build_model",
           "chunked_linear_attention", "linear_attention_step", "value_and_grad"]
