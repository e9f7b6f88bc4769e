"""The decoder LM (GQA or MLA attention, a gated MLP or MoE per layer), in
PyTorch.

A port of ``repro.models.lm`` for the attention decoders: ``forward``
(with ``logits_last_only`` and the summed MoE auxiliary loss),
``prefill``, the decode cache layout and ``decode_step``.  The reference
scans one stacked ``(R, ...)`` parameter tree of ``period`` sub-layers
with ``lax.scan``; here ``params["layers"]`` is a list of per-layer dicts
walked by a Python loop (``repro_torch.convert.lm_params_from_jax`` maps
one onto the other), while the decode cache keeps the reference's stacked
tensors: ``sub{j}`` holds layers ``j, j + period, ...`` as
``(R, batch, seq, kv_heads, d_head)`` K/V, or for MLA the
``(R, batch, seq, kv_lora)`` latent ``ckv`` and ``(R, batch, seq, d_rope)``
RoPE key ``kr``.

Configurations with Mamba2, cross-attention or an encoder are refused:
those layers are not ported yet (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
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


def _unsupported(cfg: ModelConfig) -> list[str]:
    found = [f"layer kind {k!r}" for k in cfg.pattern if k != "attn"]
    if cfg.attn_kind not in ("gqa", "mla"):
        found.append(f"attention kind {cfg.attn_kind!r}")
    if cfg.n_encoder_layers or cfg.aux_seq:
        found.append("an encoder / auxiliary cross-attention")
    return found


class LM:
    def __init__(self, cfg: ModelConfig):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
                "yet (ROADMAP queue 1 item 7); the port runs the GQA and MLA "
                "decoders, dense or MoE")
        self.cfg = cfg
        self.mla = cfg.attn_kind == "mla"
        self.period = len(cfg.pattern)
        if cfg.moe is not None:
            self.period = math.lcm(self.period, cfg.moe.every)
        if cfg.n_layers % self.period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                             f"multiple of the period {self.period}")
        # int8 KV cache (decode; GQA only, as in the reference): None =
        # config dtype
        self.kv_cache_dtype: torch.dtype | None = None

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
        return meta

    def _layer_meta(self, i: int) -> dict:
        cfg = self.cfg
        return {"mixer": L.mla_meta(cfg) if self.mla else L.attn_meta(cfg),
                "mlp": (L.moe_meta(cfg) if cfg.is_moe_layer(i)
                        else L.mlp_meta(cfg))}

    def init(self, generator: torch.Generator) -> dict:
        """Random weights in the config dtype on ``generator``'s device."""
        return materialize(self.param_meta(), generator,
                           dtype=_dtype(self.cfg))

    def _logits(self, params, x):
        cfg = self.cfg
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        unembed = (params["embed"].T if cfg.tie_embeddings
                   else params["unembed"])
        return _mask_pad_vocab((x @ unembed.to(x.dtype)).to(F32), cfg)

    # ------------------------------------------------------------- forward
    def _mlp(self, i: int, p, x):
        """Layer ``i``'s MLP or MoE residual step."""
        mlp = L.moe_apply if self.cfg.is_moe_layer(i) else L.mlp_apply
        return x + mlp(p, x, self.cfg)

    def forward(self, params, tokens, with_cache: bool = False,
                logits_last_only: bool = False):
        """tokens (B, S) -> logits (B, S, V) and the auxiliary loss (the sum
        of ``moe_aux_loss`` over the MoE layers).  With ``with_cache`` also
        the stacked per-layer caches (prefill).  ``logits_last_only`` skips
        the full (B, S, V) unembedding — prefill needs only the last
        position."""
        cfg = self.cfg
        x = params["embed"][tokens].to(_dtype(cfg))
        aux_loss = torch.zeros((), dtype=F32, device=x.device)
        kv = []
        for i, p in enumerate(params["layers"]):
            if self.mla:
                a, pair = L.mla_apply(p["mixer"], x, cfg)
            else:
                a, pair = L.attn_apply(p["mixer"], x, cfg, causal=True)
            if with_cache:
                kv.append(pair)
            x = x + a
            if cfg.is_moe_layer(i):
                aux_loss = aux_loss + L.moe_aux_loss(p["mlp"], x, cfg)
            x = self._mlp(i, p["mlp"], x)
        if logits_last_only:
            x = x[:, -1:]
        logits = self._logits(params, x)
        if with_cache:
            names = ("ckv", "kr") if self.mla else ("k", "v")
            caches = {f"sub{j}": {
                name: torch.stack([kv[i][n] for i in range(
                    j, cfg.n_layers, self.period)])
                for n, name in enumerate(names)} for j in range(self.period)}
            return logits, caches, aux_loss
        return logits, aux_loss

    # ------------------------------------------------------------- serving
    def prefill(self, params, tokens, max_len: int | None = None):
        """Run the full prompt, return (last-token logits, decode cache)."""
        logits, caches, _ = self.forward(params, tokens, with_cache=True,
                                         logits_last_only=True)
        s = tokens.shape[1]
        caches = self._grow_caches(caches, s, max_len or s)
        caches["pos"] = s
        return logits[:, -1], caches

    def _grow_caches(self, caches, s: int, max_len: int):
        """Pad the seq axis of the stacked caches (axis 2: layers, batch,
        seq) to ``max_len``."""
        if max_len <= s:
            return caches
        out = {}
        for name, sub in caches.items():
            grown = {}
            for key, x in sub.items():
                shape = list(x.shape)
                shape[2] = max_len
                grown[key] = x.new_zeros(shape)
                grown[key][:, :, :s] = x
            out[name] = grown
        return out

    def init_cache_meta(self, batch: int, max_len: int) -> dict:
        """The decode-cache structure: per sub-layer ``sub{j}`` of the
        period, stacked over its ``R`` layers, the K and V slots (and, for
        an int8 cache, their float32 scales), or for MLA the latent and the
        RoPE key in the config dtype (``kv_cache_dtype`` does not apply)."""
        cfg = self.cfg
        r = cfg.n_layers // self.period
        if self.mla:
            m = cfg.mla
            axes = ("layers", "batch", "kv_seq", None)
            sub = {name: ParamMeta((r, batch, max_len, width), axes,
                                   dtype=_dtype(cfg))
                   for name, width in (("ckv", m.kv_lora),
                                       ("kr", m.d_rope))}
        else:
            kvdt = self.kv_cache_dtype or _dtype(cfg)
            axes = ("layers", "batch", "kv_seq", "kv_heads", None)
            sub = {name: ParamMeta((r, batch, max_len, cfg.n_kv, cfg.d_head),
                                   axes, dtype=kvdt) for name in ("k", "v")}
            if self.kv_cache_dtype is not None:
                for name in ("k_s", "v_s"):
                    sub[name] = ParamMeta((r, batch, max_len, cfg.n_kv, 1),
                                          axes, dtype=F32)
        caches: dict = {f"sub{j}": dict(sub) for j in range(self.period)}
        caches["pos"] = ParamMeta((), (), dtype=torch.int32)
        return caches

    def decode_step(self, params, caches, tokens):
        """tokens (B, 1) -> (logits (B, V), updated caches).  The new K/V
        (or latent) slot is written into the cache tensors in place; the
        returned caches hold the same tensors with ``pos`` advanced."""
        cfg = self.cfg
        x = params["embed"][tokens].to(_dtype(cfg))
        pos = int(caches["pos"])
        decode = L.mla_decode if self.mla else L.attn_decode
        for i, p in enumerate(params["layers"]):
            stacked = caches[f"sub{i % self.period}"]
            layer_cache = {name: t[i // self.period]
                           for name, t in stacked.items()}
            layer_cache["pos"] = pos
            a, _ = decode(p["mixer"], x, layer_cache, cfg)
            x = x + a
            x = self._mlp(i, p["mlp"], x)
        logits = self._logits(params, x[:, 0])
        out = {name: sub for name, sub in caches.items() if name != "pos"}
        out["pos"] = pos + 1
        return logits, out
