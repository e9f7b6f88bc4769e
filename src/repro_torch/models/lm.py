"""The generic LM of the layer library, in PyTorch: all ten assigned
architectures.

* mixer pattern per layer (``"attn"`` | ``"mamba"`` | ``"xattn"``), cycled
  with period P (the pattern's length, or its lcm with the MoE period);
* a gated MLP, an MoE every k-th layer, or no MLP (``d_ff == 0``: pure
  Mamba2 blocks);
* GQA or MLA attention;
* an optional bidirectional encoder whose output every self-attention
  layer cross-attends (whisper), or cross-attention layers over the
  auxiliary embeddings themselves (llama-3.2-vision).  ``aux`` is the
  stub frontend's (B, aux_seq, d_model) embeddings.

A port of ``repro.models.lm``: ``forward`` (with ``logits_last_only`` and
the summed MoE auxiliary loss), ``loss``, ``encode``, ``prefill``, the
decode cache layout and ``decode_step``.  Under grad mode ``forward``
recomputes each layer in the backward (``torch.utils.checkpoint``), the
reference's full per-layer remat: only the layers' inputs are saved.  The reference scans one stacked ``(R, ...)``
parameter tree of ``period`` sub-layers with ``lax.scan``; here
``params["layers"]`` (and the encoder's) is a list of per-layer dicts
walked by a Python loop (``repro_torch.convert.lm_params_from_jax`` maps
one onto the other), while the decode cache keeps the reference's stacked
tensors: ``sub{j}`` holds layers ``j, j + period, ...`` as
``(R, batch, seq, kv_heads, d_head)`` K/V, for MLA the
``(R, batch, seq, kv_lora)`` latent ``ckv`` and ``(R, batch, seq, d_rope)``
RoPE key ``kr``, for Mamba2 the float32 ``(R, batch, heads, N, P)``
``state`` and the ``(R, batch, W-1, conv_dim)`` ``conv`` window, for a
cross-attention layer the ``(R, batch, aux_seq, kv_heads, d_head)`` K/V
of the memory (under ``sub{j}_x`` when it sits beside self-attention).
Only the self-attention leaves grow along the sequence
(:meth:`LM.grows`): the reference picks the leaves to pad by the length
of their axis 2 (ROADMAP R10).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.meta import ParamMeta, materialize

F32 = torch.float32


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _mask_pad_vocab(logits, cfg: ModelConfig):
    """Force pad-vocab logits to -1e30 (keeps the padded table inert)."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, -1e30)


KINDS = ("attn", "mamba", "xattn")
# the self-attention cache leaves whose axis 2 is the sequence
SEQ_LEAVES = ("k", "v", "k_s", "v_s", "ckv", "kr")


def _unsupported(cfg: ModelConfig) -> list[str]:
    found = [f"layer kind {k!r}" for k in cfg.pattern if k not in KINDS]
    if cfg.attn_kind not in ("gqa", "mla"):
        found.append(f"attention kind {cfg.attn_kind!r}")
    return found


def _stack(per_layer: list[dict]) -> dict:
    """{sub: {leaf: (R, ...)}} from the layers' {sub: {leaf: tensor}}, in
    layer order."""
    out: dict = {}
    for layer in per_layer:
        for sub, leaves in layer.items():
            for name, t in leaves.items():
                out.setdefault(sub, {}).setdefault(name, []).append(t)
    return {sub: {name: torch.stack(ts) for name, ts in leaves.items()}
            for sub, leaves in out.items()}


class LM:
    def __init__(self, cfg: ModelConfig):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} unknown to repro_torch "
                f"(layer kinds {KINDS}, attention gqa or mla)")
        self.cfg = cfg
        self.mla = cfg.attn_kind == "mla"
        self.period = len(cfg.pattern)
        if cfg.moe is not None:
            self.period = math.lcm(self.period, cfg.moe.every)
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                             f"multiple of the period {self.period}")
        self.repeats = cfg.n_layers // self.period
        self._self_attn = {f"sub{j}" for j in range(self.period)
                           if cfg.layer_kind(j) == "attn"}
        # int8 KV cache (decode; GQA only, as in the reference): None =
        # config dtype
        self.kv_cache_dtype: torch.dtype | None = None
        # (saved, interior) placements at each layer's boundary: the
        # layers' inputs, which the backward keeps, in the first, the
        # layers' insides in the second; None: as they come
        self.boundary_sp: tuple | None = None
        # the expert-parallel MoE's keywords, ``{"dp_axes": ...}``
        # (``layers.moe_apply_shardmap``): local routing on each device
        # and one all-reduce; None: ``layers.moe_apply``
        self.moe_exec: dict | None = None

    def grows(self, sub: str, leaf: str) -> bool:
        """Whether cache leaf ``leaf`` of sub-layer ``sub`` runs along the
        sequence (a self-attention layer's K/V, scales or MLA latent), so
        a prompt shorter than ``max_len`` pads it: chosen by name, never by
        the length of an axis."""
        return sub in self._self_attn and leaf in SEQ_LEAVES

    # ------------------------------------------------------------ metadata
    def param_meta(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        meta: dict = {
            "embed": ParamMeta((cfg.vocab_padded, d), ("vocab", "embed"),
                               scale=0.02),
            "final_norm": L.rmsnorm_meta(d),
            "layers": [self._layer_meta(i) for i in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            meta["unembed"] = ParamMeta((d, cfg.vocab_padded),
                                        ("embed", "vocab"))
        if cfg.n_encoder_layers:
            meta["encoder"] = {
                "layers": [{"attn": L.attn_meta(cfg), "mlp": L.mlp_meta(cfg)}
                           for _ in range(cfg.n_encoder_layers)],
                "final_norm": L.rmsnorm_meta(d),
            }
        return meta

    def _layer_meta(self, i: int) -> dict:
        cfg = self.cfg
        kind = cfg.layer_kind(i)
        meta: dict = {}
        if kind == "attn":
            meta["mixer"] = L.mla_meta(cfg) if self.mla else L.attn_meta(cfg)
            if cfg.n_encoder_layers:
                meta["xattn"] = L.attn_meta(cfg, cross=True)
        elif kind == "mamba":
            meta["mixer"] = L.mamba_meta(cfg)
        else:
            meta["mixer"] = L.attn_meta(cfg, cross=True)
        if cfg.is_moe_layer(i):
            meta["mlp"] = L.moe_meta(cfg)
        elif cfg.d_ff > 0:
            meta["mlp"] = L.mlp_meta(cfg)     # Mamba2 blocks have no MLP
        return meta

    def init(self, generator: torch.Generator) -> dict:
        """Random weights in the config dtype on ``generator``'s device."""
        return materialize(self.param_meta(), generator,
                           dtype=_dtype(self.cfg))

    def _logits(self, params, x):
        cfg = self.cfg
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        unembed = (params["embed"].T if cfg.tie_embeddings
                   else params["unembed"])
        # reduced onto the rows by hand: against an FSDP table a few rows'
        # logits come out partial, and the pad mask would leave the
        # reduction to DTensor, whose choice changes with torch's version
        logits = shard.rows_as(x @ unembed.to(x.dtype), x)
        return _mask_pad_vocab(logits.to(F32), cfg)

    # ------------------------------------------------------------- encoder
    def encode(self, params, aux):
        """Whisper-style bidirectional encoder over frame embeddings
        (B, aux_seq, d) -> the normed memory of the same shape."""
        cfg = self.cfg
        x = aux
        for p in params["encoder"]["layers"]:
            a, _ = L.attn_apply(p["attn"], x, cfg, causal=False)
            x = shard.residual(x, a)
            x = shard.residual(x, L.mlp_apply(p["mlp"], x, cfg))
        return L.rmsnorm(x, params["encoder"]["final_norm"], cfg.norm_eps)

    def _aux_memory(self, params, aux):
        """The cross-attention memory: the encoder's output (enc-dec) or
        the auxiliary embeddings themselves (vision); None without
        cross-attention."""
        cfg = self.cfg
        if not (cfg.n_encoder_layers or "xattn" in cfg.pattern):
            return None
        if aux is None:
            raise ValueError(f"{cfg.name} cross-attends auxiliary "
                             f"embeddings: pass aux of shape (batch, "
                             f"{cfg.aux_seq}, {cfg.d_model})")
        return self.encode(params, aux) if cfg.n_encoder_layers else aux

    # ------------------------------------------------------------- forward
    def _mlp(self, i: int, p, x, with_aux: bool = False):
        """Layer ``i``'s MLP or MoE residual step (none in a Mamba2
        block) and, with ``with_aux``, its MoE auxiliary loss (else, and
        for a layer without MoE, None): the expert-parallel MoE forms it
        from its own routing, the one-device MoE routes once more for
        it."""
        cfg = self.cfg
        aux = None
        if cfg.is_moe_layer(i):
            if self.moe_exec is None:
                if with_aux:
                    aux = L.moe_aux_loss(p["mlp"], x, cfg)
                y = L.moe_apply(p["mlp"], x, cfg)
            elif with_aux:
                y, aux = L.moe_apply_shardmap(p["mlp"], x, cfg, with_aux=True,
                                              **self.moe_exec)
            else:
                y = L.moe_apply_shardmap(p["mlp"], x, cfg, **self.moe_exec)
            x = shard.residual(x, y)
        elif "mlp" in p:
            x = shard.residual(x, L.mlp_apply(p["mlp"], x, cfg))
        return x, aux

    def _layer(self, i: int, p, x, memory):
        """Layer ``i``'s mixer (and cross-attention) residual steps: the
        new ``x`` and the layer's decode-cache leaves by sub-layer name."""
        cfg = self.cfg
        sub = f"sub{i % self.period}"
        kind = cfg.layer_kind(i)
        cache: dict = {}
        if kind == "attn":
            if self.mla:
                a, (ckv, kr) = L.mla_apply(p["mixer"], x, cfg)
                cache[sub] = {"ckv": ckv, "kr": kr}
            else:
                a, (k, v) = L.attn_apply(p["mixer"], x, cfg, causal=True)
                cache[sub] = {"k": k, "v": v}
            x = shard.residual(x, a)
            if cfg.n_encoder_layers:
                kv = L.xattn_kv(p["xattn"], memory, cfg)
                x = shard.residual(x, L.xattn_apply(p["xattn"], x, kv, cfg))
                cache[f"{sub}_x"] = {"k": kv[0], "v": kv[1]}
        elif kind == "mamba":
            a, cache[sub] = L.mamba_apply(p["mixer"], x, cfg)
            x = shard.residual(x, a)
        else:
            kv = L.xattn_kv(p["mixer"], memory, cfg)
            x = shard.residual(x, L.xattn_apply(p["mixer"], x, kv, cfg))
            cache[sub] = {"k": kv[0], "v": kv[1]}
        return x, cache

    def _block(self, i: int, p, x, memory):
        """Layer ``i`` whole: the new ``x``, its cache leaves and its MoE
        auxiliary loss (None for a layer without MoE).  ``boundary_sp``
        places ``x`` on the way in and out."""
        saved, interior = self.boundary_sp or (None, None)
        x, cache = self._layer(i, p, shard.constrain(x, interior), memory)
        x, aux = self._mlp(i, p, x, with_aux=True)
        return shard.constrain(x, saved), cache, aux

    def _train_block(self, i: int, p, x, memory):
        x, _, aux = self._block(i, p, x, memory)
        return x, aux

    def forward(self, params, tokens, aux=None, with_cache: bool = False,
                logits_last_only: bool = False):
        """tokens (B, S) (and ``aux`` (B, aux_seq, d) where the model
        cross-attends) -> logits (B, S, V) and the auxiliary loss (the sum
        of ``moe_aux_loss`` over the MoE layers).  With ``with_cache`` also
        the stacked per-layer caches (prefill).  ``logits_last_only`` skips
        the full (B, S, V) unembedding — prefill needs only the last
        position."""
        cfg = self.cfg
        x = shard.embed(params["embed"], tokens).to(_dtype(cfg))
        memory = self._aux_memory(params, aux)
        saved, interior = self.boundary_sp or (None, None)
        x = shard.constrain(x, saved)
        aux_loss = torch.zeros((), dtype=F32, device=x.device)
        per_layer = []
        remat = torch.is_grad_enabled() and not with_cache
        for i, p in enumerate(params["layers"]):
            if remat:
                x, aux_i = checkpoint(self._train_block, i, p, x, memory,
                                      use_reentrant=False)
            else:
                x, cache, aux_i = self._block(i, p, x, memory)
                if with_cache:
                    per_layer.append(cache)
            if aux_i is not None:
                aux_loss = aux_loss + aux_i
        x = shard.constrain(x, interior)
        if logits_last_only:
            x = x[:, -1:]
        logits = self._logits(params, x)
        if with_cache:
            return logits, _stack(per_layer), aux_loss
        return logits, aux_loss

    def loss(self, params, batch):
        """Mean next-token negative log-likelihood plus 0.01 x the MoE
        auxiliary loss, and ``{"nll", "aux_loss"}``: the logsumexp of the
        float32 (padded) logits less the gold logit.  ``batch`` holds
        ``tokens`` and ``labels`` (B, S) and, where the model
        cross-attends, ``aux``."""
        logits, aux_loss = self.forward(params, batch["tokens"],
                                        aux=batch.get("aux"))
        logz, gold = shard.logz_and_gold(logits, batch["labels"].long())
        nll = (logz - gold).mean()
        return nll + 0.01 * aux_loss, {"nll": nll, "aux_loss": aux_loss}

    # ------------------------------------------------------------- serving
    def prefill(self, params, tokens, aux=None, max_len: int | None = None):
        """Run the full prompt, return (last-token logits, decode cache)."""
        logits, caches, _ = self.forward(params, tokens, aux=aux,
                                         with_cache=True,
                                         logits_last_only=True)
        s = tokens.shape[1]
        caches = self._grow_caches(caches, s, max_len or s)
        caches["pos"] = s
        return logits[:, -1], caches

    def _grow_caches(self, caches, s: int, max_len: int):
        """Pad the sequence axis (axis 2: layers, batch, seq) of the
        self-attention leaves (:meth:`grows`) to ``max_len``, each in its
        own dtype; every other leaf stays as it is."""
        if max_len <= s:
            return caches
        out = {}
        for name, sub in caches.items():
            out[name] = dict(sub)
            for key, x in sub.items():
                if self.grows(name, key):
                    shape = list(x.shape)
                    shape[2] = max_len
                    out[name][key] = x.new_zeros(shape)
                    out[name][key][:, :, :s] = x
        return out

    def init_cache_meta(self, batch: int, max_len: int) -> dict:
        """The decode-cache structure: per sub-layer ``sub{j}`` of the
        period, stacked over its ``R`` layers.  Self-attention: the K and V
        slots (and, for an int8 cache, their float32 scales), or for MLA
        the latent and the RoPE key in the config dtype
        (``kv_cache_dtype`` does not apply); with an encoder also the
        cross K/V under ``sub{j}_x``.  Mamba2: the float32 state and the
        conv window in the config dtype.  Cross-attention: the memory's
        K/V in the config dtype."""
        cfg = self.cfg
        r, dt = self.repeats, _dtype(cfg)
        caches: dict = {}
        for j in range(self.period):
            kind = cfg.layer_kind(j)
            if kind == "attn":
                caches[f"sub{j}"] = self._attn_cache_meta(batch, max_len)
                if cfg.n_encoder_layers:
                    caches[f"sub{j}_x"] = self._xattn_cache_meta(batch)
            elif kind == "mamba":
                s = cfg.ssm
                nh = s.n_heads(cfg.d_model)
                conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
                caches[f"sub{j}"] = {
                    "state": ParamMeta((r, batch, nh, s.d_state, s.head_dim),
                                       ("layers", "batch", "heads", None,
                                        None), dtype=F32),
                    "conv": ParamMeta((r, batch, s.conv_width - 1, conv_dim),
                                      ("layers", "batch", None, "heads_dh"),
                                      dtype=dt),
                }
            else:
                caches[f"sub{j}"] = self._xattn_cache_meta(batch)
        caches["pos"] = ParamMeta((), (), dtype=torch.int32)
        return caches

    def _attn_cache_meta(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        r = self.repeats
        if self.mla:
            m = cfg.mla
            axes = ("layers", "batch", "kv_seq", None)
            return {name: ParamMeta((r, batch, max_len, width), axes,
                                    dtype=_dtype(cfg))
                    for name, width in (("ckv", m.kv_lora),
                                        ("kr", m.d_rope))}
        kvdt = self.kv_cache_dtype or _dtype(cfg)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        sub = {name: ParamMeta((r, batch, max_len, cfg.n_kv, cfg.d_head),
                               axes, dtype=kvdt) for name in ("k", "v")}
        if self.kv_cache_dtype is not None:
            for name in ("k_s", "v_s"):
                sub[name] = ParamMeta((r, batch, max_len, cfg.n_kv, 1),
                                      axes, dtype=F32)
        return sub

    def _xattn_cache_meta(self, batch: int) -> dict:
        cfg = self.cfg
        shape = (self.repeats, batch, cfg.aux_seq, cfg.n_kv, cfg.d_head)
        axes = ("layers", "batch", None, "kv_heads", None)
        return {name: ParamMeta(shape, axes, dtype=_dtype(cfg))
                for name in ("k", "v")}

    def decode_step(self, params, caches, tokens):
        """tokens (B, 1) -> (logits (B, V), updated caches).  The new K/V
        (or latent) slot and Mamba2's state and conv window are written
        into the cache tensors in place, and cross-attention reads the
        memory's K/V as the prefill left them; the returned caches hold
        the same tensors with ``pos`` advanced."""
        cfg = self.cfg
        x = shard.embed(params["embed"], tokens).to(_dtype(cfg))
        pos = int(caches["pos"])
        decode = L.mla_decode if self.mla else L.attn_decode
        for i, p in enumerate(params["layers"]):
            sub, r = f"sub{i % self.period}", i // self.period
            layer_cache = {name: t[r] for name, t in caches[sub].items()}
            kind = cfg.layer_kind(i)
            if kind == "attn":
                layer_cache["pos"] = pos
                a, _ = decode(p["mixer"], x, layer_cache, cfg)
                x = shard.residual(x, a)
                if cfg.n_encoder_layers:
                    xc = caches[f"{sub}_x"]
                    x = shard.residual(x, L.xattn_apply(
                        p["xattn"], x, (xc["k"][r], xc["v"][r]), cfg))
            elif kind == "mamba":
                a, _ = L.mamba_decode(p["mixer"], x, layer_cache, cfg)
                x = shard.residual(x, a)
            else:
                x = shard.residual(x, L.xattn_apply(
                    p["mixer"], x, (layer_cache["k"], layer_cache["v"]),
                    cfg))
            x, _ = self._mlp(i, p, x)
        logits = self._logits(params, x[:, 0])
        out = {name: sub for name, sub in caches.items() if name != "pos"}
        out["pos"] = pos + 1
        return logits, out
