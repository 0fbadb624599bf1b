"""Flash attention for LM prefill: ``ops.flash_attention`` (CUDA kernel or
plain version)."""
from .ops import flash_attention

__all__ = ["flash_attention"]
