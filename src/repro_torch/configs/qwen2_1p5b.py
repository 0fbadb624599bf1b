"""qwen2-1.5b [dense]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
GQA + QKV bias. [arXiv:2407.10671; hf]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    blocks=(BlockGroup("attn", "mlp", 28),),
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    source="arXiv:2407.10671; hf",
))
