"""llama-3.2-vision-11b [vlm] 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer. The vision
tower is a STUB: input_specs() provides precomputed patch embeddings
(B, 1601, d_model). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", n_layers=40, d_model=4096, n_heads=32,
    n_kv=8, d_head=128, d_ff=14336, vocab=128256,
    pattern=("attn", "attn", "attn", "xattn", "attn"),
    aux_seq=1601, rope_theta=500_000.0)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv=2, d_head=16, d_ff=128, vocab=256,
    pattern=("attn", "attn", "attn", "xattn", "attn"), aux_seq=16,
    attention_block=32)
