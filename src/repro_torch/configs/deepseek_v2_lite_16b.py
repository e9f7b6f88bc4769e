"""deepseek-v2-lite-16b [moe] 27L d=2048 16H, MLA (kv_lora=512),
MoE 64 routed experts top-6 + 2 shared, expert d_ff=1408, vocab=102400.
(The real model's first layer is a dense MLP; the reference makes all 27
MoE for uniform layer stacking, and so does this copy.)
[arXiv:2405.04434; hf]"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv=16, d_head=192, d_ff=1408, vocab=102400, attn_kind="mla",
    mla=MLAConfig(kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2))

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv=4, d_head=48, d_ff=64, vocab=256, attn_kind="mla",
    mla=MLAConfig(kv_lora=32, d_nope=32, d_rope=16, d_v=32),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1),
    attention_block=32)
