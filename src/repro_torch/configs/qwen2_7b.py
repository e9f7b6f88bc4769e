"""qwen2-7b [dense] 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv=4,
    d_head=128, d_ff=18944, vocab=152064, qkv_bias=True)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=128, vocab=256, qkv_bias=True, attention_block=32)
