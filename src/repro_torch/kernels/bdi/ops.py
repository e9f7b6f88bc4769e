"""Public BDI ops: per-line sizes and the compression ratio of a set of
cache lines."""
from __future__ import annotations

import torch

from repro_torch.kernels.bdi import bdi


def bdi_sizes(lines: torch.Tensor):
    """``(N, 16)`` int32 lines -> ``(sizes (N,), schemes (N,))`` int32."""
    return bdi.bdi_sizes(lines.reshape(-1, 16).contiguous())


def compression_ratio(lines: torch.Tensor) -> torch.Tensor:
    """Encoded bytes over raw bytes of ``(N, 16)`` lines, as a float64
    scalar tensor (the sizes add up exactly in int64)."""
    sizes, _ = bdi_sizes(lines)
    return sizes.sum(dtype=torch.int64).double() / (sizes.shape[0] * 64.0)
