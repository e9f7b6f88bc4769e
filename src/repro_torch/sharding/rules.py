"""Logical-axis -> mesh-axis rules for every parallelism mode.

A port of ``repro.sharding.rules``, making the same decisions.  The
production meshes are (data=16, model=16) per pod and (pod=2, data=16,
model=16) across pods. Parallelism is selected by rules, not by model
changes:

* TP       : "heads_dh"/"kv_dh"/"ffn"/"vocab" -> "model"
* EP       : "experts" -> "model" (expert weights sharded; tokens gathered)
* DP       : the "batch" activation axis -> ("pod", "data")
* FSDP     : "embed" -> "data" (ZeRO-3-style parameter+optimizer sharding
             within a pod; replicated across pods for cheap cross-pod DP)
* SP       : sequence activation axis -> "model" at norm boundaries
* KV-shard : decode caches' "kv_seq" -> "data" when the batch is too small
             to occupy the data axis (long-context decode)

A mesh is read through ``models.meta.mesh_shape``: its axis names and
sizes only.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.models.meta import ShardingRules, Spec, mesh_shape


def batch_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def make_rules(cfg: ModelConfig, *, multi_pod: bool = False,
               fsdp: bool = False, kv_seq_axis=None) -> ShardingRules:
    rules = {
        "vocab": "model",
        "embed": "data" if fsdp else None,
        "heads_dh": "model",   # fused (heads * d_head) projection dim
        "kv_dh": "model",
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "experts": "model",
        "layers": None,
        "batch": list(batch_axes(multi_pod)),
        "kv_seq": kv_seq_axis,
    }
    return ShardingRules(rules)


def wants_fsdp(cfg: ModelConfig) -> bool:
    """Full parameter+optimizer data-axis sharding: only the very largest
    models (bf16 weights alone would not fit TP-replicated)."""
    return cfg.n_params_estimate > 5.0e10


def wants_zero1(cfg: ModelConfig) -> bool:
    """ZeRO-1 (optimizer-state-only data sharding + interior activation
    pin): mid-size models whose f32 Adam moments overflow under TP-only
    sharding but whose bf16 weights fit replicated."""
    return 9.0e9 < cfg.n_params_estimate <= 5.0e10


def wants_quantized_moments(cfg: ModelConfig) -> bool:
    """int8 Adam moments for the very largest models (jamba-398B)."""
    return cfg.n_params_estimate > 1.5e11


def batch_spec(multi_pod: bool, extra_dims: int = 1) -> Spec:
    return Spec(batch_axes(multi_pod), *([None] * extra_dims))


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """Everything the dry run needs for one (arch x shape)."""
    rules: ShardingRules
    fsdp: bool
    quantized_moments: bool
    multi_pod: bool
    microbatches: int = 1
    # ZeRO-1: optimizer state sharded over data, weights only TP-sharded
    zero1: bool = False

    def opt_rules(self, cfg, multi_pod: bool) -> ShardingRules:
        if not self.zero1:
            return self.rules
        return make_rules(cfg, multi_pod=multi_pod, fsdp=True,
                          kv_seq_axis=self.rules.rules.get("kv_seq"))

    def data_shards(self, mesh) -> int:
        shape = mesh_shape(mesh)
        n = shape.get("data", 1)
        if self.multi_pod:
            n *= shape.get("pod", 1)
        return n


def plan_for(cfg: ModelConfig, shape_kind: str, global_batch: int, mesh,
             multi_pod: bool, seq_len: int = 0) -> CellPlan:
    shape = mesh_shape(mesh)
    n_data = shape.get("data", 1) * (shape.get("pod", 1) if multi_pod
                                     else 1)
    # Training: FSDP only for the very largest models (ZeRO-1 in the
    # 9-50B range). Serving: weight data-sharding from 9B up.
    if shape_kind == "train":
        fsdp = wants_fsdp(cfg)
        zero1 = wants_zero1(cfg)
    else:
        fsdp = cfg.n_params_estimate > 9.0e9
        zero1 = False
    # Decode KV caches shard their sequence dim over "model" (KV heads are
    # usually < 16 and would otherwise replicate); with an unshardable tiny
    # batch (long-context, B=1), also spread the sequence over "data".
    kv_seq_axis = None
    if shape_kind == "decode":
        kv_seq_axis = (["data", "model"]
                       if global_batch % n_data != 0 else "model")
    # microbatch count: keep per-device saved-activation stacks ~<= 4 GB
    micro = 1
    if shape_kind == "train" and seq_len:
        b_loc = max(global_batch // n_data, 1)
        stack = b_loc * seq_len * cfg.d_model * 2 * cfg.n_layers
        while micro < b_loc and stack / micro > 4e9:
            micro *= 2
    return CellPlan(
        rules=make_rules(cfg, multi_pod=multi_pod, fsdp=fsdp,
                         kv_seq_axis=kv_seq_axis),
        fsdp=fsdp,
        quantized_moments=wants_quantized_moments(cfg),
        multi_pod=multi_pod,
        microbatches=micro,
        zero1=zero1)
