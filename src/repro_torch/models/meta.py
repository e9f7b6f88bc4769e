"""Parameter metadata: one declaration of every parameter's shape, logical
axis names and initialiser, from which :func:`materialize` makes tensors.

A port of ``repro.models.meta``.  The random draws come from an explicit
``torch.Generator`` on the target device; they cannot reproduce
``jax.random``'s bits, so tests that compare the two packages carry the
reference's weights across (``repro_torch.convert.lm_params_from_jax``).
The reference's abstract shapes and sharding specs (``abstractify``,
``ShardingRules``, ``specs_for``) belong to its multi-device dry run and
have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]       # logical name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # stddev; default fan-in
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def _std(meta: ParamMeta) -> float:
    if meta.scale is not None:
        return meta.scale
    fan_in = meta.shape[0] if len(meta.shape) >= 2 else max(meta.shape[-1], 1)
    return float(1.0 / np.sqrt(max(fan_in, 1)))


def materialize(meta_tree, generator: torch.Generator, dtype=None):
    """Instantiate a meta tree (nested dicts and lists of
    :class:`ParamMeta`) as tensors on ``generator``'s device, drawing the
    normal leaves in tree order in float32 and casting to ``dtype`` (or
    each leaf's own)."""
    device = generator.device

    def build(node):
        if is_meta(node):
            dt = dtype or node.dtype
            if node.init == "zeros":
                return torch.zeros(node.shape, dtype=dt, device=device)
            if node.init == "ones":
                return torch.ones(node.shape, dtype=dt, device=device)
            x = torch.randn(node.shape, generator=generator, device=device)
            return (x * _std(node)).to(dt)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        raise TypeError(f"unexpected node {type(node).__name__} in a meta "
                        "tree")

    return build(meta_tree)
