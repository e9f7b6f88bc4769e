"""Plain PyTorch version of the flash-attention kernel: softmax attention
with the whole score matrix materialised, in float32."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q ``(BH, Sq, D)``; k ``(BH_kv, Skv, D)``, v ``(BH_kv, Skv, Dv)`` ->
    ``(BH, Sq, Dv)`` in q's type (``Dv`` may differ from ``D``, as in
    MLA).  q row ``bh`` attends kv row ``bh // (BH // BH_kv)``; causal
    attention keeps the keys ``j <= q_offset + i``."""
    bh, sq, d = q.shape
    group = bh // k.shape[0]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = k.repeat_interleave(group, dim=0).float()
    vv = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), kk) * sm_scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, vv).to(q.dtype)
