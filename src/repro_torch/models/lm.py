"""The dense decoder LM (GQA attention + gated MLP per layer), in PyTorch.

A port of the dense subset of ``repro.models.lm``: ``forward`` (with
``logits_last_only``), ``prefill``, the KV cache layout and
``decode_step``.  The reference scans one stacked ``(R, ...)`` parameter
tree with ``lax.scan``; here ``params["layers"]`` is a list of per-layer
dicts walked by a Python loop (``repro_torch.convert.lm_params_from_jax``
maps one onto the other), while the decode cache keeps the reference's
stacked ``(layers, batch, seq, kv_heads, d_head)`` tensors.

Configurations with MoE, MLA, Mamba2, cross-attention or an encoder are
refused: those layers are not ported yet (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

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
    if cfg.attn_kind != "gqa":
        found.append(f"attention kind {cfg.attn_kind!r}")
    if cfg.moe is not None:
        found.append("MoE")
    if cfg.n_encoder_layers or cfg.aux_seq:
        found.append("an encoder / auxiliary cross-attention")
    return found


class LM:
    def __init__(self, cfg: ModelConfig):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
                "yet (ROADMAP queue 1 item 11); the port runs the dense GQA "
                "decoders")
        self.cfg = cfg
        # int8 KV cache (decode): None = config dtype
        self.kv_cache_dtype: torch.dtype | None = None

    # ------------------------------------------------------------ metadata
    def param_meta(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        meta: dict = {
            "embed": ParamMeta((cfg.vocab_padded, d), ("vocab", "embed"),
                               scale=0.02),
            "final_norm": L.rmsnorm_meta(d),
            "layers": [{"mixer": L.attn_meta(cfg), "mlp": L.mlp_meta(cfg)}
                       for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            meta["unembed"] = ParamMeta((d, cfg.vocab_padded),
                                        ("embed", "vocab"))
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
        return _mask_pad_vocab((x @ unembed.to(x.dtype)).to(F32), cfg)

    # ------------------------------------------------------------- forward
    def forward(self, params, tokens, with_cache: bool = False,
                logits_last_only: bool = False):
        """tokens (B, S) -> logits (B, S, V) and the auxiliary loss (zero:
        no MoE).  With ``with_cache`` also the stacked per-layer K/V
        (prefill).  ``logits_last_only`` skips the full (B, S, V)
        unembedding — prefill needs only the last position."""
        cfg = self.cfg
        x = params["embed"][tokens].to(_dtype(cfg))
        ks, vs = [], []
        for p in params["layers"]:
            a, (k, v) = L.attn_apply(p["mixer"], x, cfg, causal=True)
            if with_cache:
                ks.append(k)
                vs.append(v)
            x = x + a
            x = x + L.mlp_apply(p["mlp"], x, cfg)
        if logits_last_only:
            x = x[:, -1:]
        logits = self._logits(params, x)
        aux_loss = torch.zeros((), dtype=F32, device=logits.device)
        if with_cache:
            caches = {"sub0": {"k": torch.stack(ks), "v": torch.stack(vs)}}
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
        """Pad the seq axis of the stacked KV caches (axis 2: layers,
        batch, seq) to ``max_len``."""
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
        """The decode-cache structure: per stacked layer axis, the K and V
        slots (and, for an int8 cache, their float32 scales)."""
        cfg = self.cfg
        r = cfg.n_layers
        kvdt = self.kv_cache_dtype or _dtype(cfg)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        sub = {name: ParamMeta((r, batch, max_len, cfg.n_kv, cfg.d_head),
                               axes, dtype=kvdt) for name in ("k", "v")}
        if self.kv_cache_dtype is not None:
            for name in ("k_s", "v_s"):
                sub[name] = ParamMeta((r, batch, max_len, cfg.n_kv, 1), axes,
                                      dtype=F32)
        return {"sub0": sub, "pos": ParamMeta((), (), dtype=torch.int32)}

    def decode_step(self, params, caches, tokens):
        """tokens (B, 1) -> (logits (B, V), updated caches).  The new K/V
        slot is written into the cache tensors in place; the returned
        caches hold the same tensors with ``pos`` advanced."""
        cfg = self.cfg
        x = params["embed"][tokens].to(_dtype(cfg))
        pos = int(caches["pos"])
        stacked = caches["sub0"]
        for i, p in enumerate(params["layers"]):
            layer_cache = {name: t[i] for name, t in stacked.items()}
            layer_cache["pos"] = pos
            a, _ = L.attn_decode(p["mixer"], x, layer_cache, cfg)
            x = x + a
            x = x + L.mlp_apply(p["mlp"], x, cfg)
        logits = self._logits(params, x[:, 0])
        return logits, {"sub0": stacked, "pos": pos + 1}
