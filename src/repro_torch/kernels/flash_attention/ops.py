"""Public flash-attention op."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention as flash_attention_kernel)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, use_kernel: bool = True,
                    sm_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention over q ``(BH, Sq, D)``, k ``(BH_kv, Skv, D)`` and v
    ``(BH_kv, Skv, Dv)``: the kernel (its plain version for CPU tensors),
    or the plain version on any device with ``use_kernel=False``."""
    if use_kernel:
        return flash_attention_kernel(q, k, v, causal=causal,
                                      sm_scale=sm_scale, q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
