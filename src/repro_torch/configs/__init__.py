"""Workload configurations of the port: the GP workloads and the LM
architecture registry (``load_all()`` imports every arch module)."""
from .base import (SHAPES, BlockGroup, ModelConfig, ShapeSpec, all_configs,
                   cells, get_config, register)
from .gp_paper import GP_CONFIGS, GPConfig

_ARCH_MODULES = [
    "qwen2_1p5b", "llama3p2_1b", "starcoder2_3b", "codeqwen1p5_7b",
    "whisper_medium", "deepseek_v2_236b", "qwen3_moe_235b", "chameleon_34b",
    "recurrentgemma_9b", "mamba2_370m",
]


def load_all():
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{m}")


__all__ = ["SHAPES", "BlockGroup", "ModelConfig", "ShapeSpec", "all_configs",
           "cells", "get_config", "register", "GP_CONFIGS", "GPConfig",
           "load_all"]
