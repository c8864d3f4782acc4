"""The model zoo's decoder family on the card (port of ``repro.models``)."""
from .api import Model, build_model
from .config import (
    EncDecConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    VLMConfig,
    XLSTMConfig,
)

__all__ = ["EncDecConfig", "MLAConfig", "Model", "ModelConfig", "MoEConfig",
           "SSMConfig", "VLMConfig", "XLSTMConfig", "build_model"]
