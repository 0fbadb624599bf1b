"""GP core: covariance, map statistics, collapsed bound, SCG, and the two
models, ``SGPR`` and ``BayesianGPLVM``, and the distributed engine
``DistributedGP``."""
from .distributed import DistributedGP
from .gplvm import BayesianGPLVM
from .sgpr import SGPR

__all__ = ["BayesianGPLVM", "DistributedGP", "SGPR"]
