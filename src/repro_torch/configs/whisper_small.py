"""whisper-small [audio] enc-dec, 12L encoder + 12L decoder, d=768 12H
d_ff=3072 vocab=51865. The conv/mel frontend is a STUB: the caller
passes precomputed frame embeddings (B, 1500, d) as ``aux``. RoPE
substitutes for learned positions, as in the reference.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", n_layers=12, d_model=768, n_heads=12, n_kv=12,
    d_head=64, d_ff=3072, vocab=51865, n_encoder_layers=12, aux_seq=1500,
    rope_theta=10_000.0)

SMOKE = ModelConfig(
    name="whisper-small-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_head=16, d_ff=128, vocab=256, n_encoder_layers=2, aux_seq=16,
    attention_block=32)
