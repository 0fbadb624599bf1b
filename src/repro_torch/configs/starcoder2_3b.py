"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
GQA, RoPE, layernorm + bias, plain-GELU MLP. [arXiv:2402.19173; hf]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    blocks=(BlockGroup("attn", "mlp", 30),),
    qkv_bias=True, rope_theta=100_000.0, norm_type="layernorm",
    mlp_type="gelu", tie_embeddings=True,
    source="arXiv:2402.19173; hf",
))
