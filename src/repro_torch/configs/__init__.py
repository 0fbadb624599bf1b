"""Workload configurations of the port."""
from .gp_paper import GP_CONFIGS, GPConfig

__all__ = ["GP_CONFIGS", "GPConfig"]
