"""Wrapper of the per-line popcount kernel (``csrc/line_bits.cu``,
``repro_line_ones``), which replaces ``line_ones_pallas``.

:func:`line_ones` launches the kernel for a CUDA tensor (and raises on
anything it cannot take) and uses the plain version of ``ref.py`` only for
a tensor on the CPU.  ``line_ones.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_cpu, require_aligned, require_cuda
from repro_torch.kernels.popcount import ref


def line_ones(lines: torch.Tensor) -> torch.Tensor:
    """``(N, 16)`` int32 line bit patterns -> ``(N,)`` int32 ones per
    64-byte line."""
    if on_cpu(lines):
        return ref.line_ones(lines)
    n = lines.shape[0]
    dev = require_cuda({"lines": lines}, {"lines": torch.int32},
                       {"lines": (n, 16)})
    require_aligned(lines=lines)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    rc = build.library("line_bits").repro_line_ones(
        build.ptr(lines), build.ptr(out), n, build.stream(dev))
    build.check(rc, "line_ones kernel")
    line_ones.launches += 1
    return out


line_ones.launches = 0
