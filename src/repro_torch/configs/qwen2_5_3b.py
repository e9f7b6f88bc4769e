"""qwen2.5-3b [dense] 36L d=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
GQA with QKV bias, tied embeddings. [hf:Qwen/Qwen2.5-3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16, n_kv=2,
    d_head=128, d_ff=11008, vocab=151936, qkv_bias=True,
    tie_embeddings=True, rope_theta=1_000_000.0)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=128, vocab=256, qkv_bias=True, tie_embeddings=True,
    attention_block=32)
