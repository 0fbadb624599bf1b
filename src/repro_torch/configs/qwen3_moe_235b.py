"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) d_ff(routed)=1536
vocab=151936. 128 experts top-8, no shared. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936,
    blocks=(BlockGroup("attn", "moe", 94),),
    rope_theta=1_000_000.0,
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
