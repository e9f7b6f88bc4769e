"""qwen3-moe-30b-a3b [moe] 48L d=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=768, no shared experts.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv=4, d_head=128, d_ff=768, vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1_000_000.0)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv=2, d_head=16, d_ff=64, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
    attention_block=32)
