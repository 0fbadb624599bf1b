"""Psi statistics of the latent map step: ``ops.psi2`` and ``ops.psi1``
(CUDA kernels or their plain versions)."""
from .ops import psi1, psi2

__all__ = ["psi1", "psi2"]
