"""Model configuration shared by all 10 assigned architectures (a copy of
``repro.models.config``: pure Python, no JAX)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    every: int = 1              # MoE every k-th layer (jamba: 2)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    # mixer pattern: per-layer kinds, cycled (period must divide n_layers).
    # kinds: "attn" | "mamba" | "xattn" (cross-attention to aux embeddings)
    pattern: tuple[str, ...] = ("attn",)
    attn_kind: str = "gqa"            # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None
    # encoder-decoder (whisper) / multimodal (vision) frontends
    n_encoder_layers: int = 0         # >0: encoder-decoder; decoder layers
                                      # get cross-attention to encoder output
    aux_seq: int = 0                  # encoder frames / image patch tokens
    # long-context handling
    attention_block: int = 512        # blockwise-attention KV block
    subquadratic: bool = False        # True for SSM/hybrid: long_500k legal
    # numerics
    dtype: str = "bfloat16"

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a TP-friendly multiple (512): embedding and
        unembedding tables use this size; loss/decode mask the pad ids.
        Mathematically inert (pad logits forced to -inf)."""
        return -(-self.vocab // 512) * 512

    @property
    def pattern_full(self) -> tuple[str, ...]:
        p = tuple(self.pattern)
        assert self.n_layers % len(p) == 0, (self.name, len(p), self.n_layers)
        return p * (self.n_layers // len(p))

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every
                                         == self.moe.every - 1)

    @property
    def n_params_estimate(self) -> float:
        """Rough parameter count (embeddings + blocks), for 6ND math."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attn_kind == "mla" and self.mla:
                    m = self.mla
                    total += d * (self.n_heads * (m.d_nope + m.d_rope))
                    total += d * (m.kv_lora + m.d_rope)
                    total += m.kv_lora * self.n_heads * (m.d_nope + m.d_v)
                    total += self.n_heads * m.d_v * d
                else:
                    total += d * self.n_heads * self.d_head * 2
                    total += d * self.n_kv * self.d_head * 2
            elif kind == "mamba":
                s = self.ssm
                di = s.d_inner(d)
                total += d * (2 * di + 2 * s.n_groups * s.d_state
                              + s.n_heads(d)) + di * d
            elif kind == "xattn":
                total += d * self.n_heads * self.d_head * 2
                total += d * self.n_kv * self.d_head * 2
            # mlp
            if self.is_moe_layer(i):
                e = self.moe
                total += (e.n_experts + e.n_shared) * 3 * d * e.d_ff_expert
                total += d * e.n_experts
            else:
                total += 3 * d * self.d_ff
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (
                4 * d * self.n_heads * self.d_head + 3 * d * self.d_ff)
            # decoder cross-attention
            total += self.n_layers * (2 * d * self.n_heads * self.d_head
                                      + 2 * d * self.n_kv * self.d_head)
        return float(total)

    def active_params_estimate(self) -> float:
        """Active (per-token) parameters for MoE models (6*N_active*D)."""
        if self.moe is None:
            return self.n_params_estimate
        e = self.moe
        inactive_frac_ff = (e.n_experts - e.top_k) / e.n_experts
        moe_layers = sum(1 for i in range(self.n_layers)
                         if self.is_moe_layer(i))
        inactive = moe_layers * e.n_experts * 3 * self.d_model \
            * e.d_ff_expert * inactive_frac_ff / e.n_experts * e.n_experts
        # simpler: routed params minus active routed params
        routed = moe_layers * e.n_experts * 3 * self.d_model * e.d_ff_expert
        active_routed = moe_layers * e.top_k * 3 * self.d_model * e.d_ff_expert
        return self.n_params_estimate - routed + active_routed
