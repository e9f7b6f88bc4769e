"""Architecture registry and the assigned input shapes.

A port of ``repro.configs.registry``: all ten architectures, as the
reference has them (the four dense GQA decoders, the two MoE ones,
mamba2-780m, the jamba hybrid, whisper-small's encoder-decoder and
llama-3.2-vision's cross-attention decoder), every (architecture x shape)
cell through :func:`all_cells`, and :func:`input_specs`, the shape-only
inputs of each cell's step that the dry run traces against.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.models.meta import abstractify

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_applicable(arch: str, shape: str) -> bool:
    """long_500k needs sub-quadratic attention: SSM and hybrid only."""
    if shape == "long_500k":
        return get_config(arch).subquadratic
    return True


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_NAMES for s in SHAPES
            if cell_applicable(a, s)]


def skipped_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_NAMES for s in SHAPES
            if not cell_applicable(a, s)]


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: int | None = None, device="cpu") -> dict:
    """The step's inputs for an (arch, shape) cell as shape-only tensors
    (fake under a ``FakeTensorMode``): train ``tokens``/``labels``, prefill
    ``tokens`` (and ``aux`` where the model cross-attends), decode one
    token a row and the caches of :meth:`LM.init_cache_meta`."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": empty((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = empty((b, s), torch.int32)
        if cfg.aux_seq:
            specs["aux"] = empty((b, cfg.aux_seq, cfg.d_model), dt)
        return specs
    if shape.kind == "decode":
        return {"tokens": empty((b, 1), torch.int32),
                "caches": abstractify(LM(cfg).init_cache_meta(b, s),
                                      device=device)}
    raise ValueError(shape.kind)
