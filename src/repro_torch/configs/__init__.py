"""Assigned architecture configs (a copy of ``repro.configs``: shapes only).

``get_config(arch_id)`` returns the FULL assigned config;
``get_smoke_config(arch_id)`` returns a reduced same-family config for CPU
smoke tests (small layers/width/vocab, few experts).

Shapes (assignment):
  train_4k     seq 4096,   global batch 256   (train_step)
  prefill_32k  seq 32768,  global batch 32    (inference prefill)
  decode_32k   seq 32768,  global batch 128   (serve_step, 1 new token)
  long_500k    seq 524288, global batch 1     (serve_step; sub-quadratic only)
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "deepseek_v2_236b",
    "granite_moe_3b_a800m",
    "h2o_danube_1_8b",
    "command_r_35b",
    "qwen2_5_3b",
    "codeqwen1_5_7b",
    "xlstm_125m",
    "whisper_tiny",
    "zamba2_1_2b",
    "phi_3_vision_4_2b",
]

# canonical dash-form ids of the assignment mapped to module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "command-r-35b": "command_r_35b",
    "qwen2.5-3b": "qwen2_5_3b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "xlstm-125m": "xlstm_125m",
    "whisper-tiny": "whisper_tiny",
    "zamba2-1.2b": "zamba2_1_2b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
})

SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}


def resolve(arch: str) -> str:
    return ALIASES.get(arch, arch)


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __package__)
    return mod.SMOKE


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (DESIGN.md §4)."""
    if shape == "long_500k":
        return cfg.subquadratic
    return True
