"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``,
``repro_flash_attention``), which replaces ``flash_attention_pallas``.

:func:`flash_attention` launches the kernel for CUDA tensors (and raises on
anything it cannot take) and uses the plain version of ``ref.py`` only for
tensors on the CPU.  ``flash_attention.launches`` counts the kernel
launches.  Unlike the Pallas kernel, the lengths need not be multiples of
a tile: the kernel masks the ragged edge itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_cpu, require_aligned, require_cuda
from repro_torch.kernels.flash_attention import ref

MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q ``(BH, Sq, D)``; k, v ``(BH_kv, Skv, D)`` with ``BH % BH_kv == 0``
    -> ``(BH, Sq, D)`` in q's type (see ``ref.attention_ref``)."""
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[0], k.shape[1]
    if bh_kv == 0 or bh % bh_kv:
        raise ValueError(f"q rows {bh} are not a multiple of kv rows {bh_kv}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if on_cpu(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                 q_offset=q_offset)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bfloat16 or float32, not "
                        f"{q.dtype}")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} must be a multiple of 8 and at most "
                         f"{MAX_HEAD_DIM}")
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention needs at least one query and key")
    dev = require_cuda({"q": q, "k": k, "v": v},
                       dict.fromkeys("qkv", q.dtype),
                       {"q": (bh, sq, d), "k": (bh_kv, skv, d),
                        "v": (bh_kv, skv, d)})
    require_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    rc = build.library("flash_attention").repro_flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), bh, bh_kv,
        sq, skv, d, float(sm_scale), int(causal), int(q_offset),
        int(q.dtype == torch.bfloat16), build.stream(dev))
    build.check(rc, "flash_attention kernel")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
