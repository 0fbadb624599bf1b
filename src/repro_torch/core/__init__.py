"""SGPR core: covariance, map statistics, collapsed bound, the SGPR model."""
from .sgpr import SGPR

__all__ = ["SGPR"]
