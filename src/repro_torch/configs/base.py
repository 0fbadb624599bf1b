"""Model/shape configuration schema and the port's architecture registry
(copy of ``repro.configs.base``).

The port keeps its own registry, apart from the JAX package's: a config
module of ``repro_torch.configs`` registers here only.  It holds the JAX
registry's ten architectures with the same numbers.  ``reduced()``
derives the CPU test config (same family/topology, tiny dims).  Input
shapes are the four ``SHAPES`` cells; ``long_500k`` is only
``runs_long``-eligible for sub-quadratic families (:func:`cells`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockGroup:
    """A run of identical layers: mixer in {attn, lattn, mla, ssd, rglru},
    ffn in {mlp, moe, none}; ``scan=True`` stacks params and lax.scans."""
    mixer: str
    ffn: str
    count: int
    scan: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | encdec | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    blocks: tuple[BlockGroup, ...]
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_type: str = "rmsnorm"
    mlp_type: str = "swiglu"
    tie_embeddings: bool = False
    local_window: int | None = None
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "sharded"        # sharded | dense
    moe_dispatch_dtype: str = "native"   # native | int8 (wire format)
    # MLA
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_kernel: int = 4
    # RG-LRU
    lru_width: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    num_frames: int = 1500
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    use_flash: bool = False
    # provenance
    source: str = ""
    runs_long: bool = False          # sub-quadratic -> long_500k eligible

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = {}
        scale["d_model"] = 64
        scale["num_heads"] = 4
        scale["num_kv_heads"] = min(self.num_kv_heads, 2) or 1
        scale["head_dim"] = 16 if self.head_dim else 0
        scale["d_ff"] = 128
        scale["vocab_size"] = 512
        scale["num_frames"] = 16
        scale["param_dtype"] = "float32"
        scale["compute_dtype"] = "float32"
        scale["remat"] = False
        scale["moe_impl"] = "dense"
        if self.num_experts:
            scale["num_experts"] = 8
            scale["experts_per_token"] = min(self.experts_per_token, 2)
            scale["moe_d_ff"] = 32
        if self.use_mla:
            scale.update(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm_state_dim:
            scale.update(ssm_state_dim=16, ssm_head_dim=16, ssm_heads=0,
                         ssm_chunk=16)
        if self.lru_width:
            scale["lru_width"] = 64
        if self.local_window:
            scale["local_window"] = 8
        # shrink the block structure but keep its shape
        blocks = []
        seen = set()
        for g in self.blocks:
            cnt = min(g.count, 2)
            blocks.append(BlockGroup(g.mixer, g.ffn, cnt, g.scan))
            seen.add((g.mixer, g.ffn))
        scale["blocks"] = tuple(blocks)
        scale["num_layers"] = sum(g.count for g in blocks)
        scale["encoder_layers"] = 2 if self.encoder_layers else 0
        return replace(self, **scale)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from . import load_all  # lazy populate
        load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        from . import load_all
        load_all()
    return dict(_REGISTRY)


def cells(cfg: ModelConfig) -> list[str]:
    """The shape cells this arch runs (long_500k only if sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.runs_long:
        out.append("long_500k")
    return out
