"""Model layers of the dense decoder: norms, RoPE, blockwise (flash)
attention with GQA, the KV-cached decode step, and the gated MLP.

A port of the dense subset of ``repro.models.layers``.

Conventions
-----------
* Every layer exposes ``*_meta(cfg) -> meta tree`` (ParamMeta leaves) and
  ``*_apply(params, ...)`` / ``*_decode(params, cache, ...)`` functions over
  dicts of tensors.
* Activations: (B, S, d_model); compute in the config dtype, reductions and
  softmax in float32.
* Full-sequence attention never materialises (S, S) on the card:
  :func:`blockwise_attention` runs the hand-written flash-attention kernel
  (``repro_torch.kernels.flash_attention``) for CUDA tensors and its plain
  version for CPU tensors.  In the reference the pure-jnp blockwise scan
  computes the same function and the Pallas kernel substitutes for it on a
  TPU.
* The decode step writes the new K/V slot into the cache tensors in place
  (the reference updates functionally and its serving loop donates the
  cache): the returned cache holds the same tensors.

MLA, MoE, Mamba2 and cross-attention are not ported yet (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.meta import ParamMeta

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norm / RoPE
# ---------------------------------------------------------------------------
def rmsnorm_meta(d: int) -> ParamMeta:
    return ParamMeta((d,), ("embed",), init="ones")


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=F32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)            # (D/2,)
    ang = positions.to(F32)[..., None] * freqs        # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]                # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2].to(F32), x[..., 1::2].to(F32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def blockwise_attention(q, k, v, *, causal: bool, block: int = 512,
                        q_offset: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Skv, Kh, D) -> (B, Sq, H, D).

    The flash-attention kernel in the reference's ``(B*H, S, D)`` layout:
    q head ``h`` of batch row ``b`` reads kv head ``h // (H // Kh)``.  The
    kernel picks its own tiles and masks ragged lengths itself, so
    ``block`` (the reference scan's kv block) does not change the result
    and is accepted for the reference's signature."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]

    def heads_major(x, n_heads, s):
        return x.permute(0, 2, 1, 3).reshape(b * n_heads, s, d).contiguous()

    o = fa_ops.flash_attention(heads_major(q, h, sq), heads_major(k, kh, skv),
                               heads_major(v, kh, skv), causal=causal,
                               q_offset=q_offset)
    return o.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-step attention over a cache. q: (B, 1, H, D);
    k/v_cache: (B, S, Kh, D); kv_len: valid prefix length."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(F32),
                          k_cache.to(F32)) * (d ** -0.5)
    mask = torch.arange(s, device=q.device) < kv_len
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return o.reshape(b, 1, h, d).to(q.dtype)


def attn_meta(cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    meta = {
        "wq": ParamMeta((d, h * dh), ("embed", "heads_dh")),
        "wk": ParamMeta((d, kv * dh), ("embed", "kv_dh")),
        "wv": ParamMeta((d, kv * dh), ("embed", "kv_dh")),
        "wo": ParamMeta((h * dh, d), ("heads_dh", "embed")),
        "norm": rmsnorm_meta(d),
    }
    if cfg.qkv_bias:
        meta["bq"] = ParamMeta((h * dh,), ("heads_dh",), init="zeros")
        meta["bk"] = ParamMeta((kv * dh,), ("kv_dh",), init="zeros")
        meta["bv"] = ParamMeta((kv * dh,), ("kv_dh",), init="zeros")
    return meta


def _qkv(params, x, cfg: ModelConfig, positions=None, rope: bool = True):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    if rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(params, x, cfg: ModelConfig, *, causal: bool = True,
               positions=None):
    """Full-sequence self-attention (prefill). Returns (out, (k, v)) so
    prefill can seed the decode cache."""
    b, s, _ = x.shape
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    q, k, v = _qkv(params, xn, cfg, positions=positions)
    o = blockwise_attention(q, k, v, causal=causal,
                            block=cfg.attention_block)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return o @ params["wo"].to(x.dtype), (k, v)


def quantize_kv(t):
    """(B, S, Kh, Dh) -> (int8 values, float32 per-(B, S, Kh) scales)."""
    tf = t.to(F32)
    absmax = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale


def attn_decode(params, x, cache, cfg: ModelConfig):
    """x: (B, 1, d); cache: {"k", "v": (B, Smax, Kh, Dh), "pos": int}.

    The int8-quantized cache variant (a data encoding in the paper's sense,
    Section 10, applied to the KV stream) additionally holds per-(B, S, Kh)
    float32 scales as "k_s"/"v_s"; K/V are dequantized into the attention
    in float32.  The new slot is written into the cache tensors in place."""
    b = x.shape[0]
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    pos = int(cache["pos"])
    q, k, v = _qkv(params, xn, cfg,
                   positions=torch.full((b, 1), pos, device=x.device))
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    if "k_s" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k"][:, pos] = kq[:, 0]
        cache["v"][:, pos] = vq[:, 0]
        cache["k_s"][:, pos] = ks[:, 0]
        cache["v_s"][:, pos] = vs[:, 0]
        k_full = cache["k"].to(F32) * cache["k_s"]
        v_full = cache["v"].to(F32) * cache["v_s"]
        o = decode_attention(q, k_full, v_full, pos + 1)
        new_cache.update(k_s=cache["k_s"], v_s=cache["v_s"])
    else:
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        o = decode_attention(q, cache["k"], cache["v"], pos + 1)
    o = o.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return o @ params["wo"].to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_meta(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wg": ParamMeta((d, f), ("embed", "ffn")),
        "wu": ParamMeta((d, f), ("embed", "ffn")),
        "wd": ParamMeta((f, d), ("ffn", "embed")),
        "norm": rmsnorm_meta(d),
    }


def mlp_apply(params, x, cfg: ModelConfig):
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    h = F.silu(xn @ params["wg"].to(x.dtype)) * (xn @ params["wu"].to(x.dtype))
    return h @ params["wd"].to(x.dtype)
