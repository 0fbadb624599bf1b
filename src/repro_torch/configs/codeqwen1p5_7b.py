"""codeqwen1.5-7b [dense]: 32L d=4096 32H (GQA kv=32 == MHA) d_ff=13440
vocab=92416. qwen1.5-arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B; hf]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    blocks=(BlockGroup("attn", "mlp", 32),),
    qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
))
