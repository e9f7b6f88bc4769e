"""AdamW over nests of tensors, with optional int8-quantized moments.

A port of ``repro.optim.adamw``.  The quantized variant stores both Adam
moments as int8 with one float32 scale per leading row (per-row absmax),
``v`` in the sqrt domain, cutting the optimizer state 4x; dequantize,
update and requantize happen inside :func:`update`, so the float32
moments exist only one leaf at a time.  ``torch.round`` rounds half to
even, as ``jnp.round`` does.

:func:`update` writes the new weights and moments into the tensors it is
given (in place: the reference's jitted step donates them, and at
qwen2.5-3b's width a second copy of weights and float32 moments would not
fit beside the first) and returns the same trees.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as T
from repro_torch.models import shard
from repro_torch.models.meta import ParamMeta, is_meta

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    quantize_moments: bool = False

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup to ``lr``, then a cosine decay to 0.1 ``lr`` over
        ``decay_steps`` (float32, as the reference)."""
        step = step.to(F32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.decay_steps - self.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (0.1 + 0.9 * cos)


def is_moment_pair(x) -> bool:
    """An int8 moment: the ``{"q", "scale"}`` pair of one parameter."""
    return isinstance(x, dict) and set(x) == {"q", "scale"}


# ---------------------------------------------------------------------------
# int8 moment quantization
# ---------------------------------------------------------------------------
def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # a row split over devices: its maxima reduced by hand (DTensor's own
    # choice, an all-reduce or a reduce-scatter and a gather, changes with
    # torch's version)
    absmax = shard.all_reduced(x.abs().amax(dim=-1, keepdim=True))
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def init(params, cfg: AdamWConfig) -> dict:
    """Zero moments (float32, or int8 with float32 row scales) for every
    parameter and a zero int32 step counter, on the parameters' device."""
    def f32_zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    def int8_zeros(p):
        scale_shape = p.shape[:-1] + (1,) if p.dim() else (1,)
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(scale_shape, dtype=F32,
                                     device=p.device)}

    zeros = int8_zeros if cfg.quantize_moments else f32_zeros
    device = T.leaves(params)[0].device
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of the sum of squares,
    in float32.  Over DTensor gradients the leaves' sums stay partial and
    their total is all-reduced once."""
    total = None     # not 0: a constant added to partial sums reduces them
    for g in T.leaves(grads):
        s = shard.as_partial(torch.sum(torch.square(g.to(F32))))
        total = s if total is None else total + s
    return torch.sqrt(shard.all_reduced(total))


def update(grads, state: dict, params, cfg: AdamWConfig):
    """One AdamW step: global-norm clipping to ``grad_clip``, bias-corrected
    moments, decoupled weight decay.  Writes the new parameters and moments
    into ``params`` and ``state`` in place and returns ``(params, state,
    {"grad_norm", "lr"})``."""
    step = state["step"] + 1
    lr = cfg.schedule(step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    bc1 = 1 - cfg.b1 ** step.to(F32)
    bc2 = 1 - cfg.b2 ** step.to(F32)

    flat_p = T.leaves(params)
    flat_g = T.leaves(grads)
    flat_m = T.leaves(state["m"], is_leaf=is_moment_pair)
    flat_v = T.leaves(state["v"], is_leaf=is_moment_pair)
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p, strict=True):
        g = g.to(F32) * clip
        if cfg.quantize_moments:
            m_f = _dequantize(m["q"], m["scale"])
            # v in the sqrt domain: int8 steps are uniform in sqrt(v), so
            # the update's denominator keeps ~1/127 of the row max
            v_f = torch.square(_dequantize(v["q"], v["scale"]))
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        mhat = m_f / bc1
        vhat = v_f / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(F32)
        p.copy_(pf - lr * (delta + cfg.weight_decay * pf))
        if cfg.quantize_moments:
            for pair, x in ((m, m_f), (v, torch.sqrt(v_f))):
                q, scale = _quantize(x)
                pair["q"].copy_(q)
                pair["scale"].copy_(scale)
        else:
            m.copy_(m_f)
            v.copy_(v_f)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_meta(param_meta, cfg: AdamWConfig) -> dict:
    """The optimizer state's :class:`ParamMeta` tree for a parameter meta
    tree."""
    def moment(m: ParamMeta):
        if cfg.quantize_moments:
            return {"q": ParamMeta(m.shape, m.logical, init="zeros",
                                   dtype=torch.int8),
                    "scale": ParamMeta(m.shape[:-1] + (1,),
                                       m.logical[:-1] + (None,),
                                       init="zeros", dtype=F32)}
        return ParamMeta(m.shape, m.logical, init="zeros", dtype=F32)

    tree = T.tree_map(moment, param_meta, is_leaf=is_meta)
    return {"m": tree, "v": tree,
            "step": ParamMeta((), (), init="zeros", dtype=torch.int32)}
