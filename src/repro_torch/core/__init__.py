"""GP core: covariance, map statistics, collapsed bound, SCG, and the two
models, ``SGPR`` and ``BayesianGPLVM``."""
from .gplvm import BayesianGPLVM
from .sgpr import SGPR

__all__ = ["BayesianGPLVM", "SGPR"]
