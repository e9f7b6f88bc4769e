"""Plain PyTorch versions of the flash-attention kernels: softmax attention
with the whole score matrix materialised (and, asked, each row's
log-normaliser, as the forward kernel writes it), K0's ``delta``, and the
backward, in float32 (or float64 for float64 inputs)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the plain versions compute in: float32, or float64
    for float64 inputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q, k, causal: bool, sm_scale: float, q_offset: int):
    """The scaled scores ``(BH, Sq, Skv)`` of q over k (k expanded to q's
    rows), the keys a causal query does not see at ``NEG_INF``."""
    sq = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", _acc(q), k) * sm_scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    return s


def _probs(q, k, causal: bool, sm_scale: float, q_offset: int):
    """The softmax weights ``(BH, Sq, Skv)`` of q over k and each row's
    log-normaliser ``(BH, Sq)``, the logsumexp of its scores."""
    s = _scores(q, k, causal, sm_scale, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return p / l, (m + torch.log(l)).squeeze(-1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: float | None = None,
                  q_offset: int = 0, return_lse: bool = False):
    """q ``(BH, Sq, D)``; k ``(BH_kv, Skv, D)``, v ``(BH_kv, Skv, Dv)`` ->
    ``(BH, Sq, Dv)`` in q's type (``Dv`` may differ from ``D``, as in
    MLA).  q row ``bh`` attends kv row ``bh // (BH // BH_kv)``; causal
    attention keeps the keys ``j <= q_offset + i``.  With ``return_lse``
    also each row's log-normaliser ``(BH, Sq)`` in float32 (float64 for
    float64 inputs): the logsumexp of its masked, scaled scores, what the
    forward kernel writes for the backward."""
    group = q.shape[0] // k.shape[0]
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    kk = _acc(k.repeat_interleave(group, dim=0))
    vv = _acc(v.repeat_interleave(group, dim=0))
    p, lse = _probs(q, kk, causal, sm_scale, q_offset)
    out = torch.einsum("bqk,bkd->bqd", p, vv).to(q.dtype)
    return (out, lse) if return_lse else out


def delta_ref(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """K0's plain version: ``rowsum(do * o)`` ``(BH, Sq)`` of the forward's
    output and its gradient, in float32 (float64 for float64 inputs)."""
    return (_acc(do) * _acc(o)).sum(-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                      sm_scale: float | None = None,
                      lse: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`attention_ref` (``q_offset = 0``) given its
    output ``o`` and the output's gradient ``do`` -> ``(dq, dk, dv)`` in
    q's, k's and v's types, the kv gradients summed over each kv row's
    group of q rows.  The steps of the backward kernels:
    ``delta = rowsum(do * o)``, ``dS = P (do v^T - delta)``,
    ``dq = scale dS k``, ``dk = scale dS^T q``, ``dv = P^T do``.  Given the
    forward's ``lse`` ``(BH, Sq)``, P is ``exp(s - lse)``, as the kernels
    form it; else the softmax of the scores."""
    bh, sq, d = q.shape
    bh_kv, skv, dv_width = v.shape
    group = bh // bh_kv
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = _acc(k.repeat_interleave(group, dim=0))
    vv = _acc(v.repeat_interleave(group, dim=0))
    qq, dd = _acc(q), _acc(do)
    if lse is None:
        p = _probs(qq, kk, causal, sm_scale, 0)[0]
    else:
        # s - lse rounded once (in float64), as the kernels' fmaf forms it
        s = _scores(qq, kk, causal, sm_scale, 0)
        p = torch.exp(s.double() - lse.double()[..., None]).to(s.dtype)
    delta = delta_ref(o, do)[..., None]
    ds = p * (torch.einsum("bqe,bke->bqk", dd, vv) - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, kk) * sm_scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qq) * sm_scale
    dv = torch.einsum("bqk,bqe->bke", p, dd)
    dk = dk.reshape(bh_kv, group, skv, d).sum(1)
    dv = dv.reshape(bh_kv, group, skv, dv_width).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
