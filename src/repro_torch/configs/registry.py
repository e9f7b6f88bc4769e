"""Architecture registry: the ten assigned names and their configurations.

A port of ``repro.configs.registry.get_config``: all ten, as the
reference has them (the four dense GQA decoders, the two MoE ones,
mamba2-780m, the jamba hybrid, whisper-small's encoder-decoder and
llama-3.2-vision's cross-attention decoder).  The dry run's shapes and
input specs (``ShapeSpec``, ``SHAPES``, ``input_specs``) are not
ported.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-8b": "granite_8b",
    "qwen2-7b": "qwen2_7b",
    "yi-34b": "yi_34b",
    "mamba2-780m": "mamba2_780m",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-small": "whisper_small",
    "jamba-1.5-large-398b": "jamba15_large_398b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{list(ARCH_NAMES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
