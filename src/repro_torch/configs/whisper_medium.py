"""whisper-medium [audio enc-dec]: 24+24L d=1024 16H (kv=16) d_ff=4096
vocab=51865. Conv frontend STUBBED: input_specs() supplies precomputed
(B, 1500, d) frame embeddings; decoder positions use RoPE instead of
learned-448 so the assigned 32k decode shapes are well-defined (DESIGN.md).
[arXiv:2212.04356; unverified]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, vocab_size=51865,
    blocks=(BlockGroup("attn", "mlp", 24),),
    norm_type="layernorm", mlp_type="gelu", rope_theta=10_000.0,
    num_frames=1500, tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
))
