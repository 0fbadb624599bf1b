"""Checkpoints in the JAX package's format (npz leaves + JSON sidecar)."""
from .checkpoint import restore, save

__all__ = ["restore", "save"]
