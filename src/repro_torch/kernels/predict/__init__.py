"""Fused serving predict step: ``ops.predict_stats`` (CUDA kernel or plain version)."""
from .ops import predict_stats

__all__ = ["predict_stats"]
