"""mamba2-370m [ssm]: 48L d=1024 attn-free, vocab=50280, ssm_state=128.
SSD (state-space duality), d_inner=2048, 32 heads x 64. Constant-state
decode => runs long_500k. [arXiv:2405.21060; unverified]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    blocks=(BlockGroup("ssd", "none", 48),),
    ssm_state_dim=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    rope_theta=0.0, tie_embeddings=True, runs_long=True,
    source="arXiv:2405.21060; unverified",
))
