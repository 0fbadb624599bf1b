"""llama3.2-1b [dense]: 16L d=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]

The numbers of ``repro.configs.llama3p2_1b``.  Like the JAX package's, it
trains and prefills through the query-chunked attention; the paths that
serve through the flash kernel ask for it with
``dataclasses.replace(cfg, use_flash=True)``."""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    blocks=(BlockGroup("attn", "mlp", 16),),
    rope_theta=500_000.0, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
))
