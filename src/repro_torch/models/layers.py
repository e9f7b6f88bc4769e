"""Model layers: norms, RoPE, blockwise (flash) attention with GQA, the
KV-cached decode step, cross-attention, MLA (DeepSeek-V2's latent
attention), the gated MLP, MoE and Mamba2 (the chunked SSD scan and its
one-token recurrence).

A port of ``repro.models.layers``.

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
  version for CPU tensors, and its gradient through the backward kernels
  (the plain backward on the CPU).  In the reference the pure-jnp
  blockwise scan computes the same function (and is what its train step
  differentiates) and the Pallas kernel substitutes for it on a TPU.
* Every op on the train path is out of place, so that autograd can take
  the gradient of every layer (the decode steps' cache writes are not on
  it).
* The decode steps write the new K/V (or latent) slot, or Mamba2's new
  state and conv window, into the cache tensors in place (the reference
  updates functionally and its serving loop donates the cache): the
  returned cache holds the same tensors.
* Cross-attention (``xattn_apply``) is non-causal attention of the
  decoder's queries over K/V projected once from the auxiliary memory
  (``xattn_kv``), in prefill and at every decode step alike, so on the
  card it runs the flash kernel at ``Sq = 1`` in decode.
* MoE dispatch departs from the reference in one place (ROADMAP R9): a
  dropped assignment goes to the spare row ``n_experts * capacity`` of the
  dispatch buffer, where the reference's ``t * top_k`` can be a kept
  token's slot.  The combine sums each token's expert outputs in a fixed
  order (ascending expert id, as the reference's scatter-add does), with
  no atomics, so the card gives the same bits every run.
* Mamba2 is eager torch: the reference has no Pallas kernel for the SSD
  scan.  ``mamba_apply`` computes every chunk's intra-chunk term and
  state contribution in one batched pass and carries the
  ``(B, heads, N, P)`` state across chunks by a prefix scan in
  ``log2(chunks)`` batched steps (the counterpart of the reference's
  sequential ``lax.scan``; the products and sums are associated
  differently, so the state agrees to rounding); it zeroes the front
  pad's inputs after the convolution, so the pad adds nothing whatever
  the conv bias (ROADMAP R11).

* With DTensor parameters (the dry run) GQA, cross-attention and MLA's
  decode pass through the sharding points of ``repro_torch.models.shard``;
  MLA's prefill, Mamba2 and ``moe_apply_shardmap`` run on each device's
  heads or experts (``shard.model_parallel``); for plain tensors those
  are the plain code.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import shard
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
    """q: (B, Sq, H, D); k: (B, Skv, Kh, D), v: (B, Skv, Kh, Dv) ->
    (B, Sq, H, Dv).

    The flash-attention kernel in the reference's ``(B*H, S, D)`` layout:
    q head ``h`` of batch row ``b`` reads kv head ``h // (H // Kh)``.  The
    kernel picks its own tiles and masks ragged lengths itself, so
    ``block`` (the reference scan's kv block) does not change the result
    and is accepted for the reference's signature."""
    b, sq, h, _ = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[-1]

    def heads_major(x, n_heads, s):
        return x.permute(0, 2, 1, 3).reshape(b * n_heads, s,
                                             x.shape[-1]).contiguous()

    o = fa_ops.flash_attention(heads_major(q, h, sq), heads_major(k, kh, skv),
                               heads_major(v, kh, skv), causal=causal,
                               q_offset=q_offset)
    return o.reshape(b, h, sq, dv).permute(0, 2, 1, 3)


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
    p = shard.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return o.reshape(b, 1, h, d).to(q.dtype)


def attn_meta(cfg: ModelConfig, cross: bool = False) -> dict:
    """Self-attention's weights, or with ``cross`` cross-attention's (no
    QKV bias)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    meta = {
        "wq": ParamMeta((d, h * dh), ("embed", "heads_dh")),
        "wk": ParamMeta((d, kv * dh), ("embed", "kv_dh")),
        "wv": ParamMeta((d, kv * dh), ("embed", "kv_dh")),
        "wo": ParamMeta((h * dh, d), ("heads_dh", "embed")),
        "norm": rmsnorm_meta(d),
    }
    if cfg.qkv_bias and not cross:
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
    q = shard.split_heads(q, h, dh)
    k = shard.split_heads(k, kv, dh)
    v = shard.split_heads(v, kv, dh)
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
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    q, k, v = _qkv(params, xn, cfg, positions=positions)
    o = shard.local_attention(blockwise_attention, q, k, v, causal=causal,
                              block=cfg.attention_block)
    return shard.merge_heads(o) @ params["wo"].to(x.dtype), (k, v)


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
    q = shard.replicate_heads(q)      # a sharded cache splits the sequence
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    if "k_s" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, t in (("k", kq), ("v", vq), ("k_s", ks), ("v_s", vs)):
            shard.write_slot(cache[name], pos, t[:, 0])
        k_full = cache["k"].to(F32) * cache["k_s"]
        v_full = cache["v"].to(F32) * cache["v_s"]
        o = decode_attention(q, k_full, v_full, pos + 1)
        new_cache.update(k_s=cache["k_s"], v_s=cache["v_s"])
    else:
        shard.write_slot(cache["k"], pos, k[:, 0])
        shard.write_slot(cache["v"], pos, v[:, 0])
        o = decode_attention(q, cache["k"], cache["v"], pos + 1)
    o = o.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return o @ params["wo"].to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# Cross-attention (vision adapters, enc-dec): K/V from auxiliary embeddings
# ---------------------------------------------------------------------------
def xattn_apply(params, x, aux_kv, cfg: ModelConfig):
    """aux_kv: precomputed (k, v): (B, S_aux, Kh, Dh).  Non-causal, with no
    RoPE on the queries, as in the reference."""
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    q = shard.split_heads(shard.rows_as(xn @ params["wq"].to(x.dtype), x),
                          cfg.n_heads, cfg.d_head)
    k, v = aux_kv
    o = shard.local_attention(blockwise_attention, q, k, v, causal=False,
                              block=cfg.attention_block)
    return shard.merge_heads(o) @ params["wo"].to(x.dtype)


def xattn_kv(params, aux, cfg: ModelConfig):
    """Project auxiliary embeddings once: (B, S_aux, d) -> (k, v), split
    into heads as the decoder's K/V are."""
    kv, dh = cfg.n_kv, cfg.d_head
    k = shard.split_heads(aux @ params["wk"].to(aux.dtype), kv, dh)
    v = shard.split_heads(aux @ params["wv"].to(aux.dtype), kv, dh)
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV latent attention
# ---------------------------------------------------------------------------
def mla_meta(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": ParamMeta((d, h * (m.d_nope + m.d_rope)), ("embed", "heads_dh")),
        "w_dkv": ParamMeta((d, m.kv_lora), ("embed", None)),
        "w_kr": ParamMeta((d, m.d_rope), ("embed", None)),
        "w_uk": ParamMeta((m.kv_lora, h * m.d_nope), (None, "heads_dh")),
        "w_uv": ParamMeta((m.kv_lora, h * m.d_v), (None, "heads_dh")),
        "wo": ParamMeta((h * m.d_v, d), ("heads_dh", "embed")),
        "norm": rmsnorm_meta(d),
        "kv_norm": ParamMeta((m.kv_lora,), (None,), init="ones"),
    }


def _mla_q_latent(params, xn, cfg: ModelConfig, positions):
    """The queries split into their no-RoPE and RoPE parts, the latent
    ``c_kv`` and the shared RoPE key, from the normed input (the heads of
    ``wq``: a device's own in :func:`mla_apply`'s body)."""
    m = cfg.mla
    h = params["wq"].shape[1] // (m.d_nope + m.d_rope)
    q = shard.split_heads(xn @ params["wq"].to(xn.dtype), h,
                          m.d_nope + m.d_rope)
    q_nope, q_rope = q[..., :m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # the latent and the RoPE key are whole on every device of a row
    w_dkv, w_kr = shard.gathered(params["w_dkv"]), shard.gathered(
        params["w_kr"])
    c_kv = rmsnorm(xn @ w_dkv.to(xn.dtype), params["kv_norm"],
                   cfg.norm_eps)                       # (B, S, kv_lora)
    k_rope = apply_rope((xn @ w_kr.to(xn.dtype))[:, :, None, :],
                        positions, cfg.rope_theta)     # (B, S, 1, d_rope)
    return q_nope, q_rope, c_kv, k_rope


# MLA's weights split over ``model`` by heads (None: whole everywhere)
MLA_DIMS = {"wq": 1, "w_dkv": None, "w_kr": None, "w_uk": 1, "w_uv": 1,
            "wo": 0, "norm": None, "kv_norm": None}


def mla_apply(params, x, cfg: ModelConfig, positions=None):
    """Prefill MLA: K and V expanded from the latent, blockwise attention
    with q/k ``d_nope + d_rope`` wide and v ``d_v`` wide; the one shared
    RoPE key is broadcast to every head.  Returns (out, (c_kv, k_rope))
    for cache seeding.  With DTensors each device runs it on its own
    heads (``shard.model_parallel``, :data:`MLA_DIMS`), the latent and
    the RoPE key whole: its input's gradient, a part on each device, is
    reduced once, where the layer takes its input."""
    m = cfg.mla

    def local(p, xl, _):
        b, s, _ = xl.shape
        if p["wq"].shape[1] % (m.d_nope + m.d_rope):
            raise ValueError(f"{cfg.n_heads} heads do not split over the "
                             "model axis")
        xn = rmsnorm(xl, p["norm"], cfg.norm_eps)
        pos = (torch.arange(s, device=xl.device)[None, :]
               if positions is None else positions)
        q_nope, q_rope, c_kv, k_rope = _mla_q_latent(p, xn, cfg, pos)
        h = q_nope.shape[2]
        k_nope = (c_kv @ p["w_uk"].to(xl.dtype)).reshape(b, s, h, m.d_nope)
        v = (c_kv @ p["w_uv"].to(xl.dtype)).reshape(b, s, h, m.d_v)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, m.d_rope)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        o = blockwise_attention(q_full, k, v, causal=True,
                                block=cfg.attention_block)
        return (o.reshape(b, s, h * m.d_v) @ p["wo"].to(xl.dtype),
                (c_kv, k_rope[:, :, 0, :]))

    return shard.model_parallel(local, params, x, MLA_DIMS,
                                out_dims=(None, None))


def mla_decode(params, x, cache, cfg: ModelConfig):
    """Absorbed-matrix MLA decode: attention runs in float32 directly over
    the latent cache ``ckv`` (B, S, kv_lora) and the shared RoPE key ``kr``
    (B, S, d_rope); the new slot is written into them in place.  With
    DTensors the absorbed products run on each device's heads, the scores
    over its sequence shard of the cache (the query's heads gathered, as
    :func:`attn_decode`'s), and the latent output is reduced back onto
    the heads before ``W_uv``."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    pos = int(cache["pos"])
    positions = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_q_latent(params, xn, cfg, positions)
    ckv, kr = cache["ckv"], cache["kr"]
    shard.write_slot(ckv, pos, c_new[:, 0])
    shard.write_slot(kr, pos, kr_new[:, 0, 0])

    # absorb W_uk into q: q' = q_nope . W_uk^T -> (B, H, kv_lora)
    w_uk = params["w_uk"].reshape(m.kv_lora, h, m.d_nope)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].to(F32), w_uk.to(F32))
    # a sharded cache splits the sequence
    q_lat = shard.replicate_heads(q_lat, dim=1)
    q_rope = shard.replicate_heads(q_rope[:, 0].to(F32), dim=1)
    s_len = ckv.shape[1]
    scores = (torch.einsum("bhl,bsl->bhs", q_lat, ckv.to(F32))
              + torch.einsum("bhr,bsr->bhs", q_rope, kr.to(F32)))
    scores = scores * ((m.d_nope + m.d_rope) ** -0.5)
    mask = torch.arange(s_len, device=x.device) < pos + 1
    scores = torch.where(mask, scores, NEG_INF)
    p = shard.softmax(scores, dim=-1)
    o_lat = shard.onto_heads(torch.einsum("bhs,bsl->bhl", p, ckv.to(F32)),
                             q_nope, 1)            # (B, H, kv_lora)
    w_uv = params["w_uv"].to(x.dtype).reshape(m.kv_lora, h, m.d_v)
    o = torch.einsum("bhl,lhv->bhv", o_lat, w_uv.to(F32))  # (B, H, d_v)
    o = o.reshape(b, 1, h * m.d_v).to(x.dtype)
    return o @ params["wo"].to(x.dtype), {"ckv": ckv, "kr": kr,
                                          "pos": pos + 1}


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
    # against FSDP weights a decode step's few rows come out as partial
    # sums, reduced here by hand before the non-linearity (DTensor's own
    # choice changes with torch's version)
    h = F.silu(shard.all_reduced(xn @ params["wg"].to(x.dtype))) \
        * shard.all_reduced(xn @ params["wu"].to(x.dtype))
    return h @ params["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-based dispatch, optional shared experts)
# ---------------------------------------------------------------------------
def moe_meta(cfg: ModelConfig) -> dict:
    e = cfg.moe
    d = cfg.d_model
    meta = {
        "router": ParamMeta((d, e.n_experts), ("embed", None), scale=0.02),
        "wg": ParamMeta((e.n_experts, d, e.d_ff_expert),
                        ("experts", "embed", "ffn")),
        "wu": ParamMeta((e.n_experts, d, e.d_ff_expert),
                        ("experts", "embed", "ffn")),
        "wd": ParamMeta((e.n_experts, e.d_ff_expert, d),
                        ("experts", "ffn", "embed")),
        "norm": rmsnorm_meta(d),
    }
    if e.n_shared:
        meta["shared"] = {
            "wg": ParamMeta((d, e.d_ff_expert * e.n_shared), ("embed", "ffn")),
            "wu": ParamMeta((d, e.d_ff_expert * e.n_shared), ("embed", "ffn")),
            "wd": ParamMeta((e.d_ff_expert * e.n_shared, d), ("ffn", "embed")),
        }
    return meta


def moe_route(params, x, cfg: ModelConfig):
    """The router of ``x`` (B, S, d): the normed tokens (T, d), the
    float32 probabilities (T, E), and the top-k experts (T, k) with their
    gates renormalised to sum to 1.  Equal probabilities go to the lower
    expert id first, as in ``jax.lax.top_k`` (a stable descending sort):
    the router logits are products in the config dtype, so in bf16 exact
    ties are common at full width."""
    e = cfg.moe
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    xf = xn.reshape(-1, x.shape[-1])
    logits = (xf @ params["router"].to(x.dtype)).to(F32)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = ranked[:, :e.top_k], order[:, :e.top_k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return xf, probs, gate, expert


def moe_capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: the reference's arithmetic,
    rounded up to a multiple of 128 once it reaches 128."""
    e = cfg.moe
    cap = max(8, int(t * e.top_k / e.n_experts * e.capacity_factor))
    if cap >= 128:
        cap = -(-cap // 128) * 128
    return cap


def moe_dispatch(expert, cfg: ModelConfig, cap: int | None = None,
                 lo: int = 0, n: int | None = None):
    """Capacity dispatch of the (T, k) chosen experts: the assignments in
    ascending expert order (a stable sort, so tokens keep their order within
    an expert) as ``order``, whether each is kept, its slot in the
    ``(n * cap + 1)``-row buffer of experts ``[lo, lo + n)`` (all ``E`` by
    default; a drop, or an assignment to another expert, goes to the
    spare last row), and the capacity (:func:`moe_capacity` by
    default)."""
    e = cfg.moe
    t = expert.shape[0]
    n = e.n_experts if n is None else n
    flat_e = expert.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e.n_experts, device=expert.device,
                               dtype=sorted_e.dtype), side="left")
    pos_in_e = torch.arange(t * e.top_k, device=expert.device) \
        - starts[sorted_e]
    cap = moe_capacity(cfg, t) if cap is None else cap
    keep = (pos_in_e < cap) & (sorted_e >= lo) & (sorted_e < lo + n)
    slot = torch.where(keep, (sorted_e - lo) * cap + pos_in_e, n * cap)
    return order, keep, slot, cap


def _moe_experts(params, xf, gate, dispatch, top_k: int):
    """The routed experts' output (T, d) of the normed tokens ``xf``: each
    of the ``n`` experts in ``params`` (``(n, d, f)`` weights) runs on its
    ``cap`` slots of ``dispatch`` (:func:`moe_dispatch`) as one batched
    product, and each token sums its kept experts' gated outputs in
    ascending expert id."""
    order, keep, slot, cap = dispatch
    n, d = params["wg"].shape[0], xf.shape[1]
    t = xf.shape[0]
    tok = order // top_k                      # the token of each assignment

    xbuf = xf.new_zeros((n * cap + 1, d))
    xbuf[slot] = xf[tok]                      # duplicates only on the spare
    xe = xbuf[:-1].view(n, cap, d)
    h = F.silu(torch.bmm(xe, params["wg"].to(xf.dtype))) \
        * torch.bmm(xe, params["wu"].to(xf.dtype))
    ybuf = torch.bmm(h, params["wd"].to(xf.dtype)).view(n * cap, d)

    flat_g = gate.reshape(-1)[order]
    contrib = torch.where(keep, flat_g, 0.0)[:, None].to(xf.dtype) \
        * ybuf[torch.clamp(slot, max=n * cap - 1)]
    # each token's k assignments by their place in `order` (ascending
    # expert id), summed in that order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * top_k, device=xf.device)
    by_expert = torch.sort(rank.view(t, top_k), dim=-1).values
    y = contrib[by_expert[:, 0]]
    for j in range(1, top_k):
        y = y + contrib[by_expert[:, j]]
    return y


def _moe_shared(params, xf, y):
    """``y`` plus the shared experts' output of ``xf`` (none: ``y``)."""
    if "shared" not in params:
        return y
    sh = params["shared"]
    hs = F.silu(xf @ sh["wg"].to(xf.dtype)) * (xf @ sh["wu"].to(xf.dtype))
    return y + hs @ sh["wd"].to(xf.dtype)


def moe_apply(params, x, cfg: ModelConfig):
    """x: (B, S, d).  Deterministic argsort dispatch with capacity drops:
    every expert runs on its ``cap`` slots as one batched product, and each
    token sums its kept experts' gated outputs in ascending expert id."""
    b, s, d = x.shape
    xf, _, gate, expert = moe_route(params, x, cfg)
    y = _moe_experts(params, xf, gate, moe_dispatch(expert, cfg),
                     cfg.moe.top_k)
    return _moe_shared(params, xf, y).reshape(b, s, d)


def _aux_from(probs, expert, cfg: ModelConfig, local: shard.Local):
    """The load-balancing loss of the routed tokens' probabilities (T, E)
    and chosen experts (T, k): the expert counts (of fixed size: a trace
    on fake tensors cannot see a size that follows the data; whole
    numbers, so exact) and the mean probabilities, each summed over the
    batch's shards once."""
    e = cfg.moe
    ids = torch.arange(e.n_experts, device=expert.device)
    counts = local.batch_sum((expert.reshape(-1, 1) == ids).sum(
        dim=0).to(F32))
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = local.batch_sum(probs.mean(dim=0))
    if local.dp:
        frac_probs = frac_probs / math.prod(local.mesh.size(i)
                                            for i in local.dp)
    return e.n_experts * (frac_tokens * frac_probs).sum()


def moe_apply_shardmap(params, x, cfg: ModelConfig, dp_axes=None,
                       with_aux: bool = False):
    """Expert-parallel MoE with local routing, as the reference's
    ``shard_map`` runs it (``shard.model_parallel``): each device routes
    its own tokens (``x`` placed over ``dp_axes``, whole over the other
    axes) to its own ``E / |model|`` experts, with a capacity per (data
    shard, expert) of ``max(8, int(t_local * top_k / E *
    capacity_factor))``; a drop, or an assignment to another device's
    expert, goes to the spare buffer row ``e_loc * cap``.  The shared
    experts, column-split over ``model``, add their part, and one
    all-reduce over ``model`` sums both.  Under FSDP the expert weights
    arrive data-sharded and are gathered here, once a layer: the
    reference's ``mesh`` and ``fsdp`` arguments are the DTensors' own
    mesh and placements.  ``with_aux`` also returns the load-balancing
    loss of this routing (:func:`moe_aux_loss`'s value), formed on each
    device from its own tokens, so its router and norm gradients are
    partial sums like the MoE's own, reduced once with them; the devices
    along ``model``, which route the same tokens, form it alike, and only
    the first passes a gradient.  For plain tensors: one device, all
    experts, the global routing at this capacity."""
    e = cfg.moe

    aux = []

    def local(p, xl, lc):
        t = xl.shape[0] * xl.shape[1]
        xf, probs, gate, expert = moe_route(p, xl, cfg)
        e_loc = p["wg"].shape[0]
        cap = max(8, int(t * e.top_k / e.n_experts * e.capacity_factor))
        dispatch = moe_dispatch(expert, cfg, cap=cap, lo=lc.rank * e_loc,
                                n=e_loc)
        y = _moe_experts(p, xf, gate, dispatch, e.top_k)
        if with_aux:
            a = _aux_from(probs, expert, cfg, lc)
            aux.append(a if lc.rank == 0 else a.detach())
        return _moe_shared(p, xf, y).reshape(xl.shape)

    dims = {"router": None, "norm": None, "wg": 0, "wu": 0, "wd": 0}
    if "shared" in params:
        dims["shared"] = {"wg": 1, "wu": 1, "wd": 0}
    y = shard.model_parallel(local, params, x, dims, dp_axes=dp_axes)
    return (y, shard.whole(aux[0], x)) if with_aux else y


def moe_aux_loss(params, x, cfg: ModelConfig):
    """Load-balancing auxiliary loss (Switch-style)."""
    _, probs, _, expert = moe_route(params, x, cfg)
    return _aux_from(probs, expert, cfg, shard.Local())


# ---------------------------------------------------------------------------
# Mamba2 (SSD: state space duality, chunked scan)
# ---------------------------------------------------------------------------
def mamba_meta(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return {
        "in_proj": ParamMeta((d, 2 * di + 2 * s.n_groups * s.d_state + nh),
                             ("embed", "heads_dh")),
        "conv_w": ParamMeta((s.conv_width, conv_dim), (None, "heads_dh"),
                            scale=0.5),
        "conv_b": ParamMeta((conv_dim,), ("heads_dh",), init="zeros"),
        "a_log": ParamMeta((nh,), ("heads",), init="zeros"),
        "d_skip": ParamMeta((nh,), ("heads",), init="ones"),
        "dt_bias": ParamMeta((nh,), ("heads",), init="zeros"),
        "out_norm": ParamMeta((di,), ("heads_dh",), init="ones"),
        "out_proj": ParamMeta((di, d), ("heads_dh", "embed")),
        "norm": rmsnorm_meta(d),
    }


# Mamba2's weights split over ``model``: the input projection and the
# conv by their columns as stored (a contiguous share, which does not fall
# on the z | xBC | dt boundaries), the per-head vectors and the output
# side by heads
MAMBA_DIMS = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "a_log": 0,
              "d_skip": 0, "dt_bias": 0, "out_norm": 0, "out_proj": 0,
              "norm": None}


def _mamba_layout(cfg: ModelConfig, lc: shard.Local):
    """The heads one device computes, as ``(groups, heads a group)``,
    and the column ranges it reads for them: of the input projection
    ``{"z", "x", "b", "c", "dt"}`` and of the conv input ``{"x", "b",
    "c"}``.  One device: every head, every column.  Over a ``model`` axis
    of ``k`` devices: ``heads / k`` heads, all in one group, whose B and
    C columns (``N`` each) every device of the group reads whole."""
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    n, p, g = s.d_state, s.head_dim, s.n_groups
    gn, hg = g * n, nh // g
    h0, h1 = lc.share(nh)
    if lc.size > 1 and hg % (h1 - h0):
        raise ValueError(f"{nh // lc.size} heads a device straddle "
                         f"{g} groups of {hg}")
    b0, b1 = (0, gn) if lc.size == 1 else (h0 // hg * n, h0 // hg * n + n)
    conv = {"x": (h0 * p, h1 * p), "b": (di + b0, di + b1),
            "c": (di + gn + b0, di + gn + b1)}
    cols = {"z": (h0 * p, h1 * p),
            **{k: (di + lo, di + hi) for k, (lo, hi) in conv.items()},
            "dt": (2 * di + 2 * gn + h0, 2 * di + 2 * gn + h1)}
    heads = (g, hg) if lc.size == 1 else (1, h1 - h0)
    return heads, cols, conv


def _cols(t, ranges, dim: int = -1):
    """``t``'s ranges ``[(lo, hi), ...]`` along ``dim``, concatenated in
    order (adjacent ranges as one slice; all of ``t``: ``t`` itself)."""
    merged: list[list[int]] = []
    for lo, hi in ranges:
        if merged and merged[-1][1] == lo:
            merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    if merged == [[0, t.shape[dim]]]:
        return t
    parts = [t.narrow(dim, lo, hi - lo) for lo, hi in merged]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _causal_conv(xbc, w, b, prev=None):
    """Depthwise causal conv along the sequence. xbc: (B, S, C); w: (W, C);
    ``prev``: the (B, W-1, C) inputs before ``xbc`` (zeros when None).
    Returns the activations and the last W-1 inputs (the decode window)."""
    width = w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2]))
    xp = torch.cat([prev.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + xp[:, i:i + xbc.shape[1]] * w[i].to(xbc.dtype)
    return F.silu(out + b.to(xbc.dtype)), xp[:, -(width - 1):]


def _mamba_gates(params, dt):
    """The float32 step ``softplus(dt + dt_bias)`` and the decay rate
    ``a = -exp(a_log)``."""
    dt = F.softplus(dt.to(F32) + params["dt_bias"].to(F32))
    return dt, -torch.exp(params["a_log"].to(F32))


def _mamba_out(params, y, xs, z, cfg: ModelConfig, dtype,
               lc: shard.Local):
    """The float32 skip term ``xs * d_skip`` added to the scan's ``y``
    (..., heads, P), cast to the config dtype, gated by ``silu(z)``, normed
    over the whole ``d_inner`` (over ``model``, the sum of squares of each
    device's heads summed) and projected out (over ``model``, each
    device's part of the sum)."""
    y = y + xs.to(F32) * params["d_skip"].to(F32)[:, None]
    y = y.reshape(*z.shape).to(dtype) * F.silu(z)
    if lc.size == 1:
        y = rmsnorm(y, params["out_norm"], cfg.norm_eps)
    else:
        yf = y.to(F32)
        var = lc.psum((yf * yf).sum(dim=-1, keepdim=True)) \
            / (yf.shape[-1] * lc.size)
        y = (yf * torch.rsqrt(var + cfg.norm_eps)).to(dtype) \
            * params["out_norm"].to(dtype)
    return y @ params["out_proj"].to(dtype)


def _mamba_scan(params, x, cfg: ModelConfig, lc: shard.Local):
    """:func:`mamba_apply` on one device's heads (``lc``; all of them on
    one device)."""
    s = cfg.ssm
    b, s0, d = x.shape
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    front = (-s0) % min(s.chunk, max(s0, 1))
    if front:
        xn = F.pad(xn, (0, 0, front, 0))
    seq = s0 + front
    (g, hg), cols, conv = _mamba_layout(cfg, lc)
    nh, p, n = g * hg, s.head_dim, s.d_state
    di, gn = nh * p, g * n
    order = [cols[k] for k in ("z", "x", "b", "c", "dt")]
    if lc.size > 1 and d <= b * seq:
        # the weight is the smaller operand: gathered whole, this
        # device's columns taken from it
        w_in = lc.gather(params["in_proj"], 1)
        proj = xn @ _cols(w_in, order).to(xn.dtype)
        full = None
    else:
        # the product is the smaller (or one device): gathered whole
        full = lc.gather(xn @ params["in_proj"].to(xn.dtype), -1)
        proj = _cols(full, order)
    z, xbc, dt = torch.split(proj, [di, di + 2 * gn, nh], dim=-1)
    conv_order = [conv[k] for k in ("x", "b", "c")]
    xbc, conv_tail = _causal_conv(
        xbc, _cols(lc.gather(params["conv_w"], 1), conv_order),
        _cols(lc.gather(params["conv_b"], 0), conv_order))
    if lc.size > 1:
        # the decode window in the cache's layout (this device's share of
        # the conv columns as stored): the last W-1 inputs of those
        # columns, from the weight or the product gathered above
        d_inner = s.d_inner(cfg.d_model)
        lo, hi = lc.share(d_inner + 2 * s.n_groups * n)
        last = slice(max(seq - (s.conv_width - 1), 0), seq)
        conv_tail = (xn[:, last] @ w_in[:, d_inner + lo:d_inner + hi].to(
            xn.dtype) if full is None
            else full[:, last, d_inner + lo:d_inner + hi])
        conv_tail = F.pad(conv_tail, (0, 0, s.conv_width - 1
                                      - conv_tail.shape[1], 0))
    if front:
        xbc = xbc.clone()
        xbc[:, :front] = 0
    xs, b_in, c_in = torch.split(xbc, [di, gn, gn], dim=-1)
    cl = min(s.chunk, seq)
    nc = seq // cl
    dt, a = _mamba_gates(params, dt)                        # (B, S, nh)
    xc = xs.reshape(b, nc, cl, g, hg, p).to(F32)
    bc = b_in.reshape(b, nc, cl, g, n).to(F32)
    cc = c_in.reshape(b, nc, cl, g, n).to(F32)
    dtc = dt.reshape(b, nc, cl, g, hg)
    cum = torch.cumsum((dt * a).reshape(b, nc, cl, g, hg), dim=2)

    # intra-chunk: y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    causal = torch.ones(cl, cl, dtype=torch.bool, device=x.device).tril()
    # masked before the exp and out of place: exp's backward reads its own
    # output, and cum_i - cum_j above the diagonal may overflow
    seg = cum[:, :, :, None] - cum[:, :, None]              # (B,c,i,j,g,h)
    decay = torch.exp(seg.masked_fill(~causal[:, :, None, None],
                                      float("-inf")))
    del seg
    scores = torch.einsum("bcign,bcjgn->bcijg", cc, bc)
    w = scores[..., None] * decay * dtc[:, :, None]
    del decay
    y = torch.einsum("bcijgh,bcjghp->bcighp", w, xc)
    del w
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(cum[:, :, -1:] - cum) * dtc          # (B,c,j,g,h)
    chunk_state = torch.einsum("bcjgn,bcjghp->bcghnp", bc,
                               xc * to_end[..., None])
    # the carry: the state leaving chunk c is s_c = s_{c-1} a_c + u_c
    # (a_c the chunk's decay, u_c its own contribution), a prefix scan of
    # the pairs (a, u) in log2(chunks) steps: each step folds in the
    # pair ``k`` chunks back
    a_c = torch.exp(cum[:, :, -1])[..., None, None]         # (B,c,g,h,1,1)
    u_c = chunk_state
    k = 1
    while k < nc:
        u_c = torch.cat([u_c[:, :k], u_c[:, k:] + a_c[:, k:] * u_c[:, :-k]],
                        dim=1)
        a_c = torch.cat([a_c[:, :k], a_c[:, k:] * a_c[:, :-k]], dim=1)
        k *= 2
    state = u_c[:, -1]
    entering = torch.cat([torch.zeros_like(u_c[:, :1]), u_c[:, :-1]],
                         dim=1)                             # (B,c,g,h,N,P)
    y = y + torch.einsum("bcign,bcghnp->bcighp", cc, entering) \
        * torch.exp(cum)[..., None]
    out = _mamba_out(params, y.reshape(b, seq, nh, p),
                     xs.reshape(b, seq, nh, p), z, cfg, x.dtype, lc)
    return out[:, front:], {"state": state.reshape(b, nh, n, p),
                            "conv": conv_tail}


def mamba_apply(params, x, cfg: ModelConfig):
    """Chunked SSD forward (prefill). x: (B, S, d) -> (out, {"state":
    float32 (B, heads, N, P), "conv": (B, W-1, conv_dim)}).

    The sequence is padded at the front to whole chunks, as in the
    reference (a zero state stays zero through the pad, unlike a tail pad
    that would corrupt the carried-out state), and the pad's conv outputs
    are zeroed so it adds nothing even with a non-zero conv bias.  B and C
    stay in their group form (no (B, S, heads, N) broadcast): heads are
    indexed (group, head in group).  Every chunk's intra-chunk term and its
    contribution to the state come from one batched pass; the state is
    carried across the chunks by a prefix scan; the carried-in state's
    term is again batched.  All three are float32; the projections run in
    the config dtype.

    With DTensors each device runs the layer on its own heads
    (``shard.model_parallel``, :data:`MAMBA_DIMS`): the input
    projection's columns of those heads (z, x and dt) and its group's B
    and C, whole, from the projection gathered over ``model``, or from
    the weight so gathered where that is the smaller; the conv on the
    same columns; the scan along the whole sequence; the output norm's
    sum of squares and the output projection summed over ``model``.  The
    state cache comes back split by heads, the conv window split by its
    columns as stored."""
    return shard.model_parallel(
        lambda p, xl, lc: _mamba_scan(p, xl, cfg, lc), params, x,
        MAMBA_DIMS, out_dims={"state": 1, "conv": 2})


def _mamba_step(params, x, cfg: ModelConfig, lc: shard.Local, state_c,
                conv_c):
    """:func:`mamba_decode` on one device's heads, its shards of the
    caches written in place: the projection gathered whole over
    ``model``, the conv on this device's share of its columns as stored
    (the cache window's own), its output gathered whole."""
    s = cfg.ssm
    b = x.shape[0]
    xn = rmsnorm(x, params["norm"], cfg.norm_eps)
    (g, hg), cols, conv = _mamba_layout(cfg, lc)
    nh, p, n = g * hg, s.head_dim, s.d_state
    full = lc.gather(xn @ params["in_proj"].to(xn.dtype), -1)
    d_inner = s.d_inner(cfg.d_model)
    lo, hi = lc.share(d_inner + 2 * s.n_groups * n)
    act, conv_tail = _causal_conv(
        _cols(full, [(d_inner + lo, d_inner + hi)]), params["conv_w"],
        params["conv_b"], prev=conv_c)
    conv_c.copy_(conv_tail)
    act = _cols(lc.gather(act, -1), [conv[k] for k in ("x", "b", "c")])
    xs, b_in, c_in = torch.split(act, [nh * p, g * n, g * n], dim=-1)
    z = _cols(full, [cols["z"]])
    dt, a = _mamba_gates(params, _cols(full, [cols["dt"]])[:, 0])
    xh = xs.reshape(b, g, hg, p).to(F32)
    bg = b_in.reshape(b, g, n).to(F32)
    cg = c_in.reshape(b, g, n).to(F32)
    state = state_c.view(b, g, hg, n, p)
    new = state * torch.exp(dt * a).view(b, g, hg, 1, 1) + torch.einsum(
        "bgn,bghp->bghnp", bg, xh * dt.view(b, g, hg, 1))
    y = torch.einsum("bgn,bghnp->bghp", cg, new)
    state.copy_(new)
    return _mamba_out(params, y.reshape(b, 1, nh, p),
                      xs.reshape(b, 1, nh, p), z, cfg, x.dtype, lc)


def mamba_decode(params, x, cache, cfg: ModelConfig):
    """Single-token recurrent step. x: (B, 1, d); cache: {"state": float32
    (B, heads, N, P), "conv": (B, W-1, conv_dim)}, both written in place
    (with DTensors each device's shards, on the device that holds them:
    the state by heads, the conv window by its columns as stored)."""
    state, conv = shard.local_of(cache["state"]), shard.local_of(
        cache["conv"])
    out = shard.model_parallel(
        lambda p, xl, lc: _mamba_step(p, xl, cfg, lc, state, conv), params,
        x, MAMBA_DIMS)
    return out, {"state": cache["state"], "conv": cache["conv"]}
