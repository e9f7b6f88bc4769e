"""Plain PyTorch version of the BDI kernel: the scheme search of
``repro_torch.core.encodings.bdi_encode_lines`` in int64 (``_fits``'s
delta ranges), without the byte packing, plus the scheme id."""
from __future__ import annotations

import torch


def _fits(deltas: torch.Tensor, nbytes: int) -> torch.Tensor:
    lim = 1 << (8 * nbytes - 1)
    return ((deltas >= -lim) & (deltas < lim)).all(dim=-1)


def bdi_sizes(lines: torch.Tensor):
    """``(N, 16)`` int32 lines -> ``(sizes, schemes)``, both ``(N,)``
    int32 (ids as in ``bdi.SCHEME_SIZES``)."""
    n = lines.shape[0]
    w = lines.to(torch.int64) & 0xFFFFFFFF               # (N, 16) unsigned
    best = torch.full((n,), 64, dtype=torch.int32, device=lines.device)
    scheme = torch.zeros_like(best)

    def take(fits, size, sid):
        nonlocal best, scheme
        upd = fits & (size < best)
        best = torch.where(upd, size, best)
        scheme = torch.where(upd, sid, scheme)

    take((w == 0).all(dim=-1), 1, 1)
    # 8-byte bases: int64 modulo 2^64 (the shift wraps into the sign bit)
    v8 = w[:, 0::2] | (w[:, 1::2] << 32)
    d8 = v8 - v8[:, :1]
    rep8 = (d8 == 0).all(dim=-1)
    take(rep8, 8, 2)
    for nb, sid in ((1, 3), (2, 4), (4, 5)):
        take(_fits(d8, nb) & ~rep8, 8 + 8 * nb, sid)
    # 4-byte bases: signed words, exact deltas
    v4 = lines.to(torch.int64)
    d4 = v4 - v4[:, :1]
    rep4 = (d4 == 0).all(dim=-1)
    take(rep4, 4, 6)
    for nb, sid in ((1, 7), (2, 8)):
        take(_fits(d4, nb) & ~rep4, 4 + 16 * nb, sid)
    # 2-byte bases: signed halves, low half first
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(n, 32)
    v2 = (halves ^ 0x8000) - 0x8000
    d2 = v2 - v2[:, :1]
    rep2 = (d2 == 0).all(dim=-1)
    take(rep2, 2, 9)
    take(_fits(d2, 1) & ~rep2, 34, 10)
    return best, scheme
