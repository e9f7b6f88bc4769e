"""granite-8b [dense] 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
Llama-style code model. [arXiv:2405.04324; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv=8,
    d_head=128, d_ff=14336, vocab=49152)

SMOKE = ModelConfig(
    name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=128, vocab=256, attention_block=32)
