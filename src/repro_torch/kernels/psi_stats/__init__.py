"""Psi statistics of the latent map step: ``ops.psi2`` and ``ops.psi1``
(CUDA kernels or their plain versions), and the ``psi2_fn`` hook."""
from .ops import psi1, psi2, psi2_fn_for_engine

__all__ = ["psi1", "psi2", "psi2_fn_for_engine"]
