"""yi-34b [dense] 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Llama-arch GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv=8,
    d_head=128, d_ff=20480, vocab=64000, rope_theta=5_000_000.0)

SMOKE = ModelConfig(
    name="yi-34b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=128, vocab=256, attention_block=32)
