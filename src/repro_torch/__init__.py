"""PyTorch + CUDA port of the distributed sparse-GP system (``repro``).

A second package beside the JAX one, which stays the reference.  It imports
torch and numpy, never jax or ``repro``.  Entry points run on CUDA unless
the caller passes ``device="cpu"``; on CUDA the SE-ARD map steps (regression
and latent), the predict step and LM prefill attention go through
hand-written kernels (``kernels/``, ``csrc/``), built with ``nvcc`` at first
use.

Ported so far: ``SGPR`` and ``BayesianGPLVM`` (map statistics, bound and
gradient, SCG ``fit``, optimal q(u)), ``extract_state`` / ``save_state`` /
``load_state`` and ``PredictEngine``; LM serving of ``llama3.2-1b``
(``models``, ``train.steps.make_prefill_step`` / ``make_serve_step``).
"""
from .core import SGPR, BayesianGPLVM
from .serve import (PredictEngine, PredictiveState, extract_state, load_state,
                    save_state, state_from_model)

__all__ = ["SGPR", "BayesianGPLVM", "PredictEngine", "PredictiveState", "extract_state",
           "load_state", "save_state", "state_from_model"]
