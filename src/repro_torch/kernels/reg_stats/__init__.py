"""Fused regression map step: ``ops.reg_stats`` (CUDA kernel or plain version)."""
from .ops import reg_stats

__all__ = ["reg_stats"]
