"""mamba2-780m [ssm] 48L d=1536, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. No MLPs (pure Mamba2 blocks), tied embeddings.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", n_layers=48, d_model=1536, n_heads=24, n_kv=24,
    d_head=64, d_ff=0, vocab=50280, pattern=("mamba",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True, subquadratic=True)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_head=16, d_ff=0, vocab=256, pattern=("mamba",),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8),
    tie_embeddings=True, subquadratic=True, attention_block=32)
