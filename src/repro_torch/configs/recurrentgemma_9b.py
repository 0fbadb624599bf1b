"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. RG-LRU + local attention (window 2048), pattern
(R, R, A) x 12 + (R, R). Sub-quadratic => runs long_500k.
[arXiv:2402.19427; unverified]"""
from .base import BlockGroup, ModelConfig, register

_PATTERN = (["rglru", "rglru", "lattn"] * 12 + ["rglru", "rglru"])
_BLOCKS = tuple(BlockGroup(m, "mlp", 1, scan=False) for m in _PATTERN)

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    blocks=_BLOCKS,
    local_window=2048, lru_width=4096, rope_theta=10_000.0,
    tie_embeddings=True, runs_long=True, param_dtype="bfloat16",
    source="arXiv:2402.19427; unverified",
))
