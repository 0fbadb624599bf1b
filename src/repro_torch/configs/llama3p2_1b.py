"""llama3.2-1b [dense]: 16L d=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]

The numbers of ``repro.configs.llama3p2_1b``, with ``use_flash=True``: the
flash kernel is the port's only prefill attention (the JAX package's
query-chunked path is not ported, ROADMAP Queue 1 item 12)."""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    blocks=(BlockGroup("attn", "mlp", 16),),
    rope_theta=500_000.0, tie_embeddings=True, use_flash=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
))
