"""Wrapper of the BDI compressibility kernel (``csrc/bdi.cu``,
``repro_bdi_sizes``), which replaces ``bdi_sizes_pallas``.

Scheme ids: 0=raw(64 B) 1=zeros(1) 2=rep8(8) 3=b8d1(16) 4=b8d2(24)
5=b8d4(40) 6=rep4(4) 7=b4d1(20) 8=b4d2(36) 9=rep2(2) 10=b2d1(34)

:func:`bdi_sizes` launches the kernel for a CUDA tensor (and raises on
anything it cannot take) and uses the plain version of ``ref.py`` only for
a tensor on the CPU.  ``bdi_sizes.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bdi import ref
from repro_torch.kernels.common import on_cpu, require_aligned, require_cuda

SCHEME_SIZES = {0: 64, 1: 1, 2: 8, 3: 16, 4: 24, 5: 40, 6: 4, 7: 20,
                8: 36, 9: 2, 10: 34}


def bdi_sizes(lines: torch.Tensor):
    """``(N, 16)`` int32 lines -> ``(sizes, schemes)``, both ``(N,)``
    int32: the smallest BDI encoding of each line and its scheme id."""
    if on_cpu(lines):
        return ref.bdi_sizes(lines)
    n = lines.shape[0]
    dev = require_cuda({"lines": lines}, {"lines": torch.int32},
                       {"lines": (n, 16)})
    require_aligned(lines=lines)
    sizes = torch.empty(n, dtype=torch.int32, device=dev)
    schemes = torch.empty(n, dtype=torch.int32, device=dev)
    rc = build.library("bdi").repro_bdi_sizes(
        build.ptr(lines), build.ptr(sizes), build.ptr(schemes), n,
        build.stream(dev))
    build.check(rc, "bdi kernel")
    bdi_sizes.launches += 1
    return sizes, schemes


bdi_sizes.launches = 0
