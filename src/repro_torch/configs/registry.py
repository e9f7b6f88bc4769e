"""Architecture registry: the ten assigned names and their configurations.

A port of ``repro.configs.registry.get_config``.  The four dense GQA
decoders and the two MoE ones (qwen3-moe-30b-a3b with GQA,
deepseek-v2-lite-16b with MLA) are here as the reference has them; the
other four need layers the port does not have yet (Mamba2,
cross-attention, an encoder) and raise.  The dry run's shapes and input specs (``ShapeSpec``, ``SHAPES``,
``input_specs``) are not ported.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-8b": "granite_8b",
    "qwen2-7b": "qwen2_7b",
    "yi-34b": "yi_34b",
    "mamba2-780m": None,
    "llama-3.2-vision-11b": None,
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-small": None,
    "jamba-1.5-large-398b": None,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{list(ARCH_NAMES)}")
    module = _MODULES[name]
    if module is None:
        raise NotImplementedError(
            f"{name} needs layers repro_torch does not have yet (Mamba2, "
            "cross-attention or an encoder; ROADMAP queue 1 item 7)")
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    return mod.SMOKE if smoke else mod.CONFIG
