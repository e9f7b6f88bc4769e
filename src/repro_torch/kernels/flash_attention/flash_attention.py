"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``,
``repro_flash_attention``), which replaces ``flash_attention_pallas``.

:func:`flash_attention` launches the kernel for CUDA tensors (and raises on
anything it cannot take) and uses the plain version of ``ref.py`` only for
tensors on the CPU.  ``flash_attention.launches`` counts the kernel
launches.  The kernel has no backward (ROADMAP F7): :func:`refuse_grad`
stops a launch whose inputs would need one.  Unlike the Pallas kernel,
the lengths need not be multiples of a tile: the kernel masks the ragged
edge itself, and v may be narrower than q and k (MLA's 128-wide values
under 192-wide queries and keys).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_cpu, require_aligned, require_cuda
from repro_torch.kernels.flash_attention import ref

# the bf16 kernel's instances: (q/k width, v width), each padded to 64
BF16_WIDTHS = ((64, 64), (128, 128), (192, 128))


def _padded(x: int) -> int:
    return -(-x // 64) * 64


def kernel_takes(d: int, dv: int, dtype: torch.dtype) -> bool:
    """Whether the kernel has an instance for q/k width ``d`` and v width
    ``dv`` (multiples of 8, ``dv <= d``) in ``dtype``: bf16 by the widths
    padded to 64 (:data:`BF16_WIDTHS`); float32 ``dv == d <= 128``, or
    ``d <= 192`` with ``dv <= 128``."""
    if d % 8 or dv % 8 or not 0 < dv <= d:
        return False
    if dtype == torch.bfloat16:
        return (_padded(d), _padded(dv)) in BF16_WIDTHS
    return dv == d <= 128 or (d <= 192 and dv <= 128)


def refuse_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """F7's guard: raise when grad mode is on and q, k or v requires grad.
    The kernel's output has no ``grad_fn``, so a backward through it would
    leave the attention's projections without gradients and say nothing;
    the plain version (CPU tensors) stays differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention (F7): an input requires grad under grad mode, "
            "but the card's attention has no backward yet (ROADMAP queue 1 "
            "item 3); call it under torch.no_grad() or on tensors that do "
            "not require grad")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q ``(BH, Sq, D)``; k ``(BH_kv, Skv, D)``, v ``(BH_kv, Skv, Dv)`` with
    ``BH % BH_kv == 0`` and ``Dv <= D`` -> ``(BH, Sq, Dv)`` in q's type (see
    ``ref.attention_ref``)."""
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[0], k.shape[1]
    dv = v.shape[-1]
    if bh_kv == 0 or bh % bh_kv:
        raise ValueError(f"q rows {bh} are not a multiple of kv rows {bh_kv}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if on_cpu(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                 q_offset=q_offset)
    refuse_grad(q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bfloat16 or float32, not "
                        f"{q.dtype}")
    if not kernel_takes(d, dv, q.dtype):
        raise ValueError(
            f"head dims q/k {d}, v {dv}: each must be a multiple of 8 with "
            f"v's at most q's, and the {q.dtype} kernel has no instance for "
            f"them (bf16 widths padded to 64: {BF16_WIDTHS}; float32: equal "
            "widths up to 128, or up to 192 with v's up to 128)")
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention needs at least one query and key")
    dev = require_cuda({"q": q, "k": k, "v": v},
                       dict.fromkeys("qkv", q.dtype),
                       {"q": (bh, sq, d), "k": (bh_kv, skv, d),
                        "v": (bh_kv, skv, dv)})
    require_aligned(q=q, k=k, v=v)
    out = q.new_empty((bh, sq, dv))
    rc = build.library("flash_attention").repro_flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), bh, bh_kv,
        sq, skv, d, dv, float(sm_scale), int(causal), int(q_offset),
        int(q.dtype == torch.bfloat16), build.stream(dev))
    build.check(rc, "flash_attention kernel")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
