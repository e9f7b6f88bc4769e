"""jamba-1.5-large-398b [hybrid] 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536; Mamba+attention 1:7 interleave, MoE 16 experts top-2 every
second layer. [arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
    n_kv=8, d_head=128, d_ff=24576, vocab=65536,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba"),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    subquadratic=True)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv=2, d_head=16, d_ff=128, vocab=256,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba"),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, every=2),
    subquadratic=True, attention_block=32)
