"""GP core: covariance expressions, map statistics and their online fold,
collapsed bound, rank-k Cholesky update, SCG, the two models ``SGPR`` and
``BayesianGPLVM``, and the distributed engine ``DistributedGP``."""
from .chol_update import chol_downdate_rank_k, chol_update_rank_k
from .covariance import (SEARD, Linear, Matern32, Periodic, Product, Sum,
                         kernel_from_spec)
from .distributed import DistributedGP
from .gplvm import BayesianGPLVM
from .sgpr import SGPR
from .stats import (Stats, downdate_stats, fold_stats, partial_stats,
                    partial_stats_chunked, zero_stats)

__all__ = ["BayesianGPLVM", "DistributedGP", "SGPR", "SEARD", "Matern32",
           "Linear", "Periodic", "Sum", "Product", "kernel_from_spec",
           "Stats", "chol_downdate_rank_k", "chol_update_rank_k",
           "downdate_stats", "fold_stats", "partial_stats",
           "partial_stats_chunked", "zero_stats"]
