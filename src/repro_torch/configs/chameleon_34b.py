"""chameleon-34b [vlm]: 48L d=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion: VQ image tokens share the text vocab, so the backbone is a
dense decoder; the VQ-GAN tokenizer frontend is STUBBED (the token ids
fed in already include image tokens). [arXiv:2405.09818;
unverified]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    blocks=(BlockGroup("attn", "mlp", 48),),
    param_dtype="bfloat16",
    source="arXiv:2405.09818; unverified",
))
